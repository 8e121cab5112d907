"""Concurrency-correctness checker — the CLI over incubator_brpc_tpu_torch.analysis.

Usage (``CHECK`` = ``python -m incubator_brpc_tpu_torch.tools.check``):
    CHECK --all                # everything (CI entry point)
    CHECK --locks              # lock-discipline rules only
    CHECK --invariants         # project-invariant lints only
    CHECK --device             # device-plane rules only
    CHECK --dump-graph         # print the acquisition graph
    CHECK --dump-inventory     # print the lock census
    CHECK --dump-device-census # print the device-site census
    CHECK --update-manifest    # add new static edges with
                               # TODO whys (edit before commit)
    CHECK --all --json out.json

Exit codes: 0 clean, 1 violations, 2 internal/config error.

Violations are diffs, not noise: the canonical lock-order manifest
(incubator_brpc_tpu_torch/analysis/lock_order.json), the device-transfer
manifest (.../device_transfers.json), and the allowlist
(.../allowlist.json) are checked in; every entry carries a one-line
justification, and stale entries fail the check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# the smoke floor: a refactor that silently breaks the scanner (moved
# package, parse failure swallowed, empty census) must fail LOUDLY, not
# report a clean tree it never looked at.  Just under the port's own
# census when these were set: 123 lock sites and 87 device sites.
MIN_LOCK_SITES = 120
MIN_DEVICE_SITES = 84

# which pass owns each rule: allowlist staleness for a rule is only
# decidable when that rule's pass actually ran
RULE_PASS = {
    "lock-order-cycle": "locks",
    "lock-order-new-edge": "locks",
    "blocking-under-lock": "locks",
    "callback-under-lock": "locks",
    "metrics-unrenderable": "invariants",
    "todo-review-why": "locks",
    "tls-restore": "invariants",
    "completion-guard": "invariants",
    "except-swallow": "invariants",
    "chaos-site-doc": "invariants",
    "chaos-site-test": "invariants",
    "host-sync-on-hot-path": "device",
    "transfer-manifest": "device",
    "transfer-manifest-stale": "device",
    "raw-jit-retrace": "device",
    "slot-lifecycle": "device",
    "read-after-donate": "device",
    "device-dispatch-under-lock": "device",
}


def run_check(
    locks: bool = True,
    invariants: bool = True,
    device: bool = True,
    min_sites: int = MIN_LOCK_SITES,
    min_device_sites: int = MIN_DEVICE_SITES,
) -> dict:
    from incubator_brpc_tpu_torch.analysis import devicegraph
    from incubator_brpc_tpu_torch.analysis import invariants as inv_lints
    from incubator_brpc_tpu_torch.analysis.findings import (
        Finding,
        load_allowlist,
        todo_review_findings,
    )
    from incubator_brpc_tpu_torch.analysis.inventory import build_inventory
    from incubator_brpc_tpu_torch.analysis.lockgraph import build_graph
    from incubator_brpc_tpu_torch.analysis.manifest import (
        check_graph_against_manifest,
        load_manifest,
    )

    allowlist = load_allowlist(
        os.path.join(PKG_ROOT, "analysis", "allowlist.json")
    )
    findings = []
    warnings = []
    # placeholder justifications ("TODO review ...") in the allowlist
    # itself are violations — checked whenever the allowlist loads
    findings.extend(todo_review_findings(allowlist))
    inv = build_inventory(PKG_ROOT)
    site_count = len(inv.sites)
    if site_count < min_sites:
        raise RuntimeError(
            f"lock census found only {site_count} sites (< {min_sites}): "
            f"the scanner is broken or scanning the wrong tree"
        )
    graph = None
    if locks or device:
        graph = build_graph(inv)
    if locks:
        from incubator_brpc_tpu_torch.analysis.manifest import (
            todo_review_findings as manifest_todo_findings,
        )

        findings.extend(graph.findings)
        manifest = load_manifest()
        mf, stale = check_graph_against_manifest(graph, manifest)
        findings.extend(mf)
        findings.extend(manifest_todo_findings(manifest))
        warnings.extend(stale)
    if invariants:
        findings.extend(inv_lints.run_all(REPO_ROOT, PKG_ROOT))
    device_site_count = 0
    if device:
        try:
            census = devicegraph.build_device_census(PKG_ROOT)
            dmanifest = devicegraph.load_device_manifest()
        except ValueError as e:
            # a malformed transfer manifest (blank why, dup key) is a
            # config error, not a findings diff
            raise RuntimeError(str(e))
        device_site_count = len(census.sites)
        if device_site_count < min_device_sites:
            raise RuntimeError(
                f"device census found only {device_site_count} sites "
                f"(< {min_device_sites}): the scanner is broken or "
                f"scanning the wrong tree"
            )
        findings.extend(devicegraph.run_device_rules(census, dmanifest))
        findings.extend(devicegraph.run_dispatch_under_lock(graph))

    violations, allowed, unused = allowlist.split(findings)
    ran = {
        p
        for p, on in (
            ("locks", locks), ("invariants", invariants), ("device", device)
        )
        if on
    }
    if ran != {"locks", "invariants", "device"}:
        # partial mode: entries for the rules whose pass did not run
        # are legitimately unmatched — staleness is only decidable when
        # the owning pass ran
        unused = [e for e in unused if RULE_PASS.get(e.get("rule")) in ran]
    for e in unused:
        violations.append(
            Finding(
                rule="stale-allowlist-entry",
                key=f"{e.get('rule')}/{e.get('key')}",
                message=(
                    f"allowlist entry [{e.get('rule')}] {e.get('key')!r} "
                    f"matches no finding — remove it (its violation is gone)"
                ),
            )
        )
    return {
        "lock_sites": site_count,
        "device_sites": device_site_count,
        "edges": (
            sorted(f"{e.src} -> {e.dst}" for e in graph.edges)
            if graph is not None
            else []
        ),
        "unresolved_acquisitions": (
            len(graph.unresolved) if graph is not None else 0
        ),
        "violations": violations,
        "allowed": allowed,
        "warnings": warnings,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--locks", action="store_true")
    ap.add_argument("--invariants", action="store_true")
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--dump-graph", action="store_true")
    ap.add_argument("--dump-inventory", action="store_true")
    ap.add_argument("--dump-device-census", action="store_true")
    ap.add_argument("--update-manifest", action="store_true")
    ap.add_argument("--min-sites", type=int, default=MIN_LOCK_SITES)
    ap.add_argument(
        "--min-device-sites", type=int, default=MIN_DEVICE_SITES
    )
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    from incubator_brpc_tpu_torch.analysis.inventory import build_inventory

    if args.dump_inventory:
        inv = build_inventory(PKG_ROOT)
        for s in sorted(inv.sites, key=lambda s: s.name):
            alias = f"  (alias of {s.alias_of})" if s.alias_of else ""
            print(f"{s.kind:<10} {s.name}  [{s.module}:{s.line}]{alias}")
        print(f"total: {len(inv.sites)} sites")
        return 0

    if args.dump_device_census:
        from incubator_brpc_tpu_torch.analysis.devicegraph import (
            build_device_census,
        )

        census = build_device_census(PKG_ROOT)
        for s in sorted(
            census.sites, key=lambda s: (s.module, s.line)
        ):
            sync = f" sync={s.sync}" if s.sync else ""
            scope = f" scope={s.scope_key}" if s.scope_key else ""
            print(
                f"{s.kind:<14} {s.module}:{s.func}:{s.line}  "
                f"{s.detail}{sync}{scope}"
            )
        print(f"total: {len(census.sites)} device sites")
        return 0

    if args.dump_graph:
        from incubator_brpc_tpu_torch.analysis.lockgraph import build_graph

        inv = build_inventory(PKG_ROOT)
        g = build_graph(inv)
        for e in sorted(g.edges, key=lambda e: (e.src, e.dst)):
            via = f"  via {e.via}" if e.via else ""
            print(f"{e.src} -> {e.dst}  [{e.module}:{e.line}]{via}")
        print(f"total: {len(g.edges)} edges, "
              f"{len(g.unresolved)} unresolved acquisitions")
        return 0

    if args.update_manifest:
        from incubator_brpc_tpu_torch.analysis.lockgraph import build_graph
        from incubator_brpc_tpu_torch.analysis.manifest import (
            load_manifest,
            update_manifest_from_graph,
        )

        inv = build_inventory(PKG_ROOT)
        g = build_graph(inv)
        m = load_manifest()
        n = update_manifest_from_graph(g, m)
        print(f"added {n} edge(s) — edit the TODO whys before committing")
        return 0

    any_pass = args.locks or args.invariants or args.device
    locks = args.all or args.locks or not any_pass
    invariants = args.all or args.invariants or not any_pass
    device = args.all or args.device or not any_pass
    try:
        result = run_check(
            locks=locks,
            invariants=invariants,
            device=device,
            min_sites=args.min_sites,
            min_device_sites=args.min_device_sites,
        )
    except RuntimeError as e:
        print(f"FATAL: {e}", file=sys.stderr)
        return 2

    if args.json:
        payload = {
            "lock_sites": result["lock_sites"],
            "device_sites": result["device_sites"],
            "edges": result["edges"],
            "unresolved_acquisitions": result["unresolved_acquisitions"],
            "violations": [vars(f) for f in result["violations"]],
            "allowed": [vars(f) for f in result["allowed"]],
            "warnings": result["warnings"],
        }
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)

    if not args.quiet:
        print(
            f"scanned {result['lock_sites']} lock sites, "
            f"{result['device_sites']} device sites, "
            f"{len(result['edges'])} acquisition edges "
            f"({result['unresolved_acquisitions']} unresolved), "
            f"{len(result['allowed'])} allowlisted finding(s)"
        )
        for w in result["warnings"]:
            print(f"warning: {w}")
    if result["violations"]:
        print(f"\n{len(result['violations'])} violation(s):", file=sys.stderr)
        for f in result["violations"]:
            print("  " + f.format(), file=sys.stderr)
        return 1
    if not args.quiet:
        print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

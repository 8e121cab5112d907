"""The map from each test function of the JAX package's suites to the port
case that covers it, and the checks that keep the map true.

``PARITY`` has one key, ``"tests/test_x.py::test_name"``, for every test
function of the 55 JAX test files (``tests/test_*.py`` but
``test_torch_*``; class methods would be keyed ``Class::name``).  A value is
either a list of port cases (``"tests/test_torch_y.py::test_name"``) that
hold the same behaviour, or a pair ``(reason, "tests/test_x.py:LINE")``
citing the JAX line the port does not carry, optionally followed by the
port cases that hold what remains (a triple).  The reasons are a closed set:

* ``timing``: a qps, latency or overhead threshold on the CPU; the
  structure of the test is held by the port case in the row.
* ``jax-only``: the test asserts JAX, XLA or Pallas machinery that means
  nothing in the port; the row names the port counterpart where one exists.
* ``fault-kept``: a fault of the JAX package that the port fixed; the row
  names the port case that asserts the fix.
* ``later``: allowed only for the host suites over copied modules, each
  named in a ROADMAP item.

A file carried by ``tests/torch_carry.py`` maps name for name: its rows are
derived here from the file it carries, not written out.
"""

import ast
import pathlib
import re

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
REASONS = {"timing", "jax-only", "fault-kept", "later"}
# the host suites over copied modules: the only files a "later" row may name
LATER_ALLOWED = {
    "test_metrics.py", "test_runtime.py", "test_utils.py", "test_json2pb.py",
    "test_redis.py", "test_observability_depth.py",
    "test_residual_components.py", "test_advice_regressions.py",
    "test_auth.py", "test_naming_remote.py", "test_mcpack_trackme.py",
    "test_trackme.py", "test_ssl.py", "test_http_builtin.py",
    "test_native_engine.py",
}

# every row of a JAX file that is not carried by the loader
EXPLICIT = {
    # test_analysis.py
    "tests/test_analysis.py::test_inventory_scale_and_known_sites": ["tests/test_torch_analysis_carried.py::test_inventory_scale_and_known_sites"],
    "tests/test_analysis.py::test_inventory_resolves_condition_aliases": ["tests/test_torch_analysis_carried.py::test_inventory_resolves_condition_aliases"],
    "tests/test_analysis.py::test_check_all_exits_zero_on_tree": ["tests/test_torch_analysis_carried.py::test_check_all_exits_zero_on_tree"],
    "tests/test_analysis.py::test_smoke_guard_fails_on_impossible_site_floor": ["tests/test_torch_analysis.py::test_smoke_guard_fails_on_impossible_site_floor"],
    "tests/test_analysis.py::test_manifest_edges_all_justified": ["tests/test_torch_analysis_carried.py::test_manifest_edges_all_justified"],
    "tests/test_analysis.py::test_allowlist_rejects_unjustified_entry": ["tests/test_torch_analysis_carried.py::test_allowlist_rejects_unjustified_entry"],
    "tests/test_analysis.py::test_stale_allowlist_entry_is_a_violation": ["tests/test_torch_analysis_carried.py::test_stale_allowlist_entry_is_a_violation"],
    "tests/test_analysis.py::test_todo_review_placeholder_why_is_a_finding": ["tests/test_torch_analysis_carried.py::test_todo_review_placeholder_why_is_a_finding"],
    "tests/test_analysis.py::test_todo_review_wired_into_check_all": ["tests/test_torch_analysis_carried.py::test_todo_review_wired_into_check_all"],
    "tests/test_analysis.py::test_fixture_inversion_cycle_detected": ["tests/test_torch_analysis_carried.py::test_fixture_inversion_cycle_detected"],
    "tests/test_analysis.py::test_fixture_blocking_under_lock_fires": ["tests/test_torch_analysis_carried.py::test_fixture_blocking_under_lock_fires"],
    "tests/test_analysis.py::test_fixture_callback_under_lock_fires": ["tests/test_torch_analysis_carried.py::test_fixture_callback_under_lock_fires"],
    "tests/test_analysis.py::test_fixture_tls_restore_fires": ["tests/test_torch_analysis_carried.py::test_fixture_tls_restore_fires"],
    "tests/test_analysis.py::test_fixture_except_swallow_fires": ["tests/test_torch_analysis_carried.py::test_fixture_except_swallow_fires"],
    "tests/test_analysis.py::test_fixture_completion_guard_fires": ["tests/test_torch_analysis_carried.py::test_fixture_completion_guard_fires"],
    "tests/test_analysis.py::test_fixture_unregistered_chaos_site_fires": ["tests/test_torch_analysis_carried.py::test_fixture_unregistered_chaos_site_fires"],
    "tests/test_analysis.py::test_metrics_lint_flags_string_variable": ["tests/test_torch_analysis.py::test_metrics_lint_flags_string_variable"],
    "tests/test_analysis.py::test_every_chaos_site_documented_and_tested": ["tests/test_torch_analysis_carried.py::test_every_chaos_site_documented_and_tested"],
    "tests/test_analysis.py::test_completion_guards_hold_on_tree": ["tests/test_torch_analysis_carried.py::test_completion_guards_hold_on_tree"],
    "tests/test_analysis.py::test_witness_detects_runtime_inversion": ["tests/test_torch_analysis.py::test_witness_detects_runtime_inversion"],
    "tests/test_analysis.py::test_witness_folds_reentrant_and_alias_acquisitions": ["tests/test_torch_analysis.py::test_witness_folds_reentrant_and_alias_acquisitions"],
    "tests/test_analysis.py::test_witness_global_patch_wraps_only_scoped_creations": ["tests/test_torch_analysis.py::test_witness_global_patch_wraps_only_scoped_creations"],
    "tests/test_analysis.py::test_asan_ubsan_engine_smoke": ["tests/test_torch_analysis_carried.py::test_asan_ubsan_engine_smoke"],
    "tests/test_analysis.py::test_witness_subset_run_consistent_with_manifest": ["tests/test_torch_analysis_carried.py::test_witness_subset_run_consistent_with_manifest"],
    # test_batching.py
    "tests/test_batching.py::test_policy_buckets_and_validation": ["tests/test_torch_batching.py::test_policy_buckets_and_validation"],
    "tests/test_batching.py::test_off_policy_builds_no_batcher": ["tests/test_torch_batching.py::test_off_policy_builds_no_batcher"],
    "tests/test_batching.py::test_single_request_fallback_without_batching": ["tests/test_torch_batching.py::test_single_request_fallback_without_batching"],
    "tests/test_batching.py::test_batched_execution_counts_requests_not_batches": ["tests/test_torch_batching.py::test_batched_execution_counts_requests_not_batches"],
    "tests/test_batching.py::test_mixed_batch_sheds_expired_row_and_executes_survivors": ["tests/test_torch_batching.py::test_mixed_batch_sheds_expired_row_and_executes_survivors"],
    "tests/test_batching.py::test_row_already_past_deadline_at_submit_never_reaches_user_code": ["tests/test_torch_batching.py::test_row_already_past_deadline_at_submit_never_reaches_user_code"],
    "tests/test_batching.py::test_deadline_guard_flushes_before_budget_exhausted": ["tests/test_torch_batching.py::test_deadline_guard_flushes_before_budget_exhausted"],
    "tests/test_batching.py::test_deadline_shed_over_tcp_closes_span": ["tests/test_torch_batching.py::test_deadline_shed_over_tcp_closes_span"],
    "tests/test_batching.py::test_queue_cap_sheds_overflow_instead_of_growing_unbounded": ["tests/test_torch_batching.py::test_queue_cap_sheds_overflow_instead_of_growing_unbounded"],
    "tests/test_batching.py::test_padding_buckets_bound_jit_retraces": ["tests/test_torch_batching.py::test_padding_buckets_bound_jit_retraces"],
    "tests/test_batching.py::test_chaos_batch_flush_replay_fires_identical_traversals": ["tests/test_torch_batching.py::test_chaos_batch_flush_replay_fires_identical_traversals"],
    "tests/test_batching.py::test_chaos_flush_drop_sheds_cleanly_under_recovery_harness": ["tests/test_torch_batching.py::test_chaos_flush_drop_sheds_cleanly_under_recovery_harness"],
    "tests/test_batching.py::test_batching_page_get_post_and_status_surfacing": ["tests/test_torch_batching_carried.py::test_batching_page_get_post_and_status_surfacing"],
    "tests/test_batching.py::test_disable_method_batching_restores_direct_path": ["tests/test_torch_batching.py::test_disable_method_batching_restores_direct_path"],
    # test_bench_smoke.py
    "tests/test_bench_smoke.py::test_echo_4kb_native_smoke":
        ("timing", "tests/test_bench_smoke.py:59", ["tests/test_torch_bench.py::test_echo_4kb_native_smoke"]),
    "tests/test_bench_smoke.py::test_echo_size_curve_no_crater":
        ("timing", "tests/test_bench_smoke.py:72", ["tests/test_torch_bench.py::test_echo_size_curve_has_every_point"]),
    "tests/test_bench_smoke.py::test_chaos_disarmed_overhead_guard":
        ("timing", "tests/test_bench_smoke.py:118", ["tests/test_torch_bench.py::test_chaos_disarmed_overhead_estimator"]),
    "tests/test_bench_smoke.py::test_echo_4kb_pyapi_smoke":
        ("timing", "tests/test_bench_smoke.py:168", ["tests/test_torch_bench.py::test_echo_4kb_pyapi_smoke"]),
    "tests/test_bench_smoke.py::test_ring_bench_structure_guard": ["tests/test_torch_bench.py::test_ring_bench_structure_guard", "tests/test_torch_ring.py::test_ring_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_ring_window_hits_micro_batcher_smoke": ["tests/test_torch_bench.py::test_ring_window_hits_micro_batcher_smoke"],
    "tests/test_bench_smoke.py::test_shard_window_bench_structure_guard": ["tests/test_torch_bench.py::test_shard_window_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_server_ring_bench_structure_guard": ["tests/test_torch_bench.py::test_server_ring_bench_structure_guard", "tests/test_torch_ring.py::test_server_ring_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_ici_bench_structure_and_dispatch_guard": ["tests/test_torch_bench.py::test_ici_bench_structure_and_dispatch_guard"],
    "tests/test_bench_smoke.py::test_batched_device_op_structure_guard": ["tests/test_torch_bench.py::test_batched_device_op_structure_guard"],
    "tests/test_bench_smoke.py::test_ici_pipeline_curve_structure": ["tests/test_torch_bench.py::test_ici_pipeline_curve_structure"],
    "tests/test_bench_smoke.py::test_ici_pallas_hit_path_structure_guard": ["tests/test_torch_bench.py::test_ici_pallas_hit_path_structure_guard"],
    "tests/test_bench_smoke.py::test_resharding_bulk_move_bench_structure_guard": ["tests/test_torch_bench.py::test_resharding_bulk_move_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_streaming_generate_structure_guard": ["tests/test_torch_bench.py::test_streaming_generate_structure_guard"],
    "tests/test_bench_smoke.py::test_disagg_serving_structure_guard": ["tests/test_torch_bench.py::test_disagg_serving_structure_guard"],
    "tests/test_bench_smoke.py::test_device_witness_bench_structure_guard": ["tests/test_torch_bench.py::test_device_witness_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_hbm_cache_bench_structure_guard": ["tests/test_torch_bench.py::test_hbm_cache_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_overload_storm_bench_structure_guard":
        ("timing", "tests/test_bench_smoke.py:719",
         ["tests/test_torch_bench.py::test_overload_storm_bench_structure_guard"]),
    "tests/test_bench_smoke.py::test_sharded_ps_structure_guard": ["tests/test_torch_bench.py::test_sharded_ps_structure_guard"],
    "tests/test_bench_smoke.py::test_cluster_scrape_bench_structure_guard": ["tests/test_torch_bench.py::test_cluster_scrape_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_cluster_stitch_and_merge_invariants": ["tests/test_torch_bench.py::test_cluster_stitch_and_merge_invariants"],
    "tests/test_bench_smoke.py::test_resharding_bench_structure_guard": ["tests/test_torch_bench.py::test_resharding_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_profiler_overhead_bench_structure_guard": ["tests/test_torch_bench.py::test_profiler_overhead_bench_structure_guard"],
    "tests/test_bench_smoke.py::test_replicated_ps_bench_structure_guard":
        ("timing", "tests/test_bench_smoke.py:971",
         ["tests/test_torch_bench.py::test_replicated_ps_bench_structure_guard"]),
    # test_cache_cluster.py
    "tests/test_cache_cluster.py::test_kill_local_replica_dcn_spill_then_health_check_revival": ["tests/test_torch_cache_cluster.py::test_kill_local_replica_dcn_spill_then_health_check_revival"],
    "tests/test_cache_cluster.py::test_membership_shrink_reroutes_remaining_replica": ["tests/test_torch_cache_cluster.py::test_membership_shrink_reroutes_remaining_replica"],
    # test_chaos_recovery.py
    "tests/test_chaos_recovery.py::test_backoff_schedule_is_seeded_and_deterministic": ["tests/test_torch_chaos_recovery.py::test_backoff_schedule_is_seeded_and_deterministic"],
    "tests/test_chaos_recovery.py::test_backoff_skipped_when_budget_nearly_gone": ["tests/test_torch_chaos_recovery.py::test_backoff_skipped_when_budget_nearly_gone"],
    "tests/test_chaos_recovery.py::test_retry_backoff_spacing_under_injected_resets": ["tests/test_torch_chaos_recovery.py::test_retry_backoff_spacing_under_injected_resets"],
    "tests/test_chaos_recovery.py::test_pooled_controller_carries_nothing_across_failed_call": ["tests/test_torch_chaos_recovery.py::test_pooled_controller_carries_nothing_across_failed_call"],
    "tests/test_chaos_recovery.py::test_pooled_controller_wipe_after_reset_mid_call_native": ["tests/test_torch_chaos_recovery.py::test_pooled_controller_wipe_after_reset_mid_call_native"],
    "tests/test_chaos_recovery.py::test_circuit_breaker_half_open_cycle": ["tests/test_torch_chaos_recovery.py::test_circuit_breaker_half_open_cycle"],
    "tests/test_chaos_recovery.py::test_cluster_recover_policy_ratio": ["tests/test_torch_chaos_recovery.py::test_cluster_recover_policy_ratio"],
    "tests/test_chaos_recovery.py::test_cluster_survives_75pct_injected_isolation": ["tests/test_torch_chaos_recovery.py::test_cluster_survives_75pct_injected_isolation"],
    "tests/test_chaos_recovery.py::test_parallel_channel_legs_degrade_gracefully": ["tests/test_torch_chaos_recovery.py::test_parallel_channel_legs_degrade_gracefully"],
    "tests/test_chaos_recovery.py::test_ici_leg_drop_times_out_then_recovers": ["tests/test_torch_chaos.py::test_ici_leg_drop_times_out_then_recovers"],
    "tests/test_chaos_recovery.py::test_ici_close_mid_batch_releases_receive_window": ["tests/test_torch_chaos_recovery.py::test_ici_close_mid_batch_releases_receive_window"],
    "tests/test_chaos_recovery.py::test_harness_end_to_end_with_recovery_invariants": ["tests/test_torch_chaos_recovery.py::test_harness_end_to_end_with_recovery_invariants"],
    # test_cluster.py
    "tests/test_cluster.py::test_list_ns_round_robin": ["tests/test_torch_cluster_carried.py::test_list_ns_round_robin"],
    "tests/test_cluster.py::test_list_ns_weighted": ["tests/test_torch_cluster_carried.py::test_list_ns_weighted"],
    "tests/test_cluster.py::test_random_lb": ["tests/test_torch_cluster_carried.py::test_random_lb"],
    "tests/test_cluster.py::test_consistent_hashing_sticky": ["tests/test_torch_cluster_carried.py::test_consistent_hashing_sticky"],
    "tests/test_cluster.py::test_locality_aware_prefers_fast": ["tests/test_torch_cluster_carried.py::test_locality_aware_prefers_fast"],
    "tests/test_cluster.py::test_file_ns_watches_changes": ["tests/test_torch_cluster_carried.py::test_file_ns_watches_changes"],
    "tests/test_cluster.py::test_dead_server_isolated_and_revived": ["tests/test_torch_cluster_carried.py::test_dead_server_isolated_and_revived"],
    "tests/test_cluster.py::test_backup_request_hedges_slow_server": ["tests/test_torch_cluster_carried.py::test_backup_request_hedges_slow_server"],
    "tests/test_cluster.py::test_tpu_topology_ns": ["tests/test_torch_cluster_carried.py::test_tpu_topology_ns"],
    # test_cluster_observability.py
    "tests/test_cluster_observability.py::test_trace_id_round_trip_across_surfaces": ["tests/test_torch_cluster_observability.py::test_trace_id_round_trip_across_surfaces"],
    "tests/test_cluster_observability.py::test_merged_percentiles_exactly_equal_pooled": ["tests/test_torch_combo.py::test_merged_percentiles_exactly_equal_pooled"],
    "tests/test_cluster_observability.py::test_intrecorder_and_multidimension_mergeable_state": ["tests/test_torch_combo.py::test_intrecorder_and_multidimension_mergeable_state"],
    "tests/test_cluster_observability.py::test_stitched_trace_across_shard_processes": ["tests/test_torch_cluster_observability.py::test_stitched_trace_across_shard_processes"],
    "tests/test_cluster_observability.py::test_cluster_latency_breakdown_merges_replicas_exactly": ["tests/test_torch_cluster_observability.py::test_cluster_latency_breakdown_merges_replicas_exactly", "tests/test_torch_repairs.py::test_phase_stats_print_the_reference_values_for_a_seeded_recorder"],
    "tests/test_cluster_observability.py::test_cluster_pages_reject_bad_input": ["tests/test_torch_cluster_observability.py::test_cluster_pages_reject_bad_input"],
    "tests/test_cluster_observability.py::test_resolve_replicas_forms": ["tests/test_torch_cluster_observability.py::test_resolve_replicas_forms"],
    "tests/test_cluster_observability.py::test_straggler_chaos_regression_names_the_slow_shard":
        ("timing", "tests/test_cluster_observability.py:526",
         ["tests/test_torch_cluster_observability.py::test_straggler_chaos_regression_names_the_slow_shard"]),
    "tests/test_cluster_observability.py::test_straggler_tracker_report_math": ["tests/test_torch_combo.py::test_straggler_tracker_report_math"],
    "tests/test_cluster_observability.py::test_fanout_legs_carry_server_time": ["tests/test_torch_combo.py::test_fanout_legs_carry_server_time"],
    "tests/test_cluster_observability.py::test_rpc_dump_builtin_capture_and_read_back": ["tests/test_torch_cluster_observability.py::test_rpc_dump_builtin_capture_and_read_back"],
    # test_connection_types.py
    "tests/test_connection_types.py::test_http_defaults_to_pooled_and_uses_distinct_connections": ["tests/test_torch_native.py::test_http_defaults_to_pooled_and_uses_distinct_connections", "tests/test_torch_repairs.py::test_a_connection_counts_before_its_first_request_is_handled"],
    "tests/test_connection_types.py::test_short_connection_closes_after_rpc": ["tests/test_torch_native.py::test_short_connection_closes_after_rpc"],
    "tests/test_connection_types.py::test_connect_timeout_ms_is_honored": ["tests/test_torch_native.py::test_connect_timeout_ms_is_honored"],
    "tests/test_connection_types.py::test_internal_port_serves_builtins_public_denies": ["tests/test_torch_native.py::test_internal_port_serves_builtins_public_denies"],
    "tests/test_connection_types.py::test_idle_connection_reaper": ["tests/test_torch_native.py::test_idle_connection_reaper"],
    # test_dcn.py
    "tests/test_dcn.py::test_cross_process_ici_echo": ["tests/test_torch_dcn.py::test_cross_process_ici_echo"],
    "tests/test_dcn.py::test_cross_process_device_payload": ["tests/test_torch_dcn_carried.py::test_cross_process_device_payload"],
    "tests/test_dcn.py::test_tpu_ns_resolves_remote_servers": ["tests/test_torch_dcn.py::test_tpu_ns_resolves_remote_servers"],
    "tests/test_dcn.py::test_cross_process_multi_segment_overlap": ["tests/test_torch_dcn.py::test_cross_process_multi_segment_overlap"],
    "tests/test_dcn.py::test_same_host_bridge_upgrades_to_uds": ["tests/test_torch_dcn.py::test_same_host_bridge_upgrades_to_uds"],
    "tests/test_dcn.py::test_uds_bridge_socket_is_private": ["tests/test_torch_dcn.py::test_uds_bridge_socket_is_private"],
    "tests/test_dcn.py::test_bridge_priming_exchange": ["tests/test_torch_dcn.py::test_bridge_priming_exchange"],
    "tests/test_dcn.py::test_dcn_bulk_echo_no_first_transfer_straggler": ["tests/test_torch_dcn.py::test_dcn_bulk_echo_no_first_transfer_straggler"],
    # test_device_analysis.py
    "tests/test_device_analysis.py::test_census_scale_and_known_sites_on_tree":
        ("jax-only", "tests/test_device_analysis.py:53",
         ["tests/test_torch_analysis.py::test_census_floor_and_kinds_on_the_tree",
          "tests/test_torch_analysis.py::test_kernel_launch_census_is_the_three_wrappers"]),
    "tests/test_device_analysis.py::test_fixture_host_sync_rule_fires":
        ["tests/test_torch_analysis.py::test_twin_rule_fires_on_the_jax_function_names",
         "tests/test_torch_analysis.py::test_twin_host_sync_keys_carry_their_torch_labels"],
    "tests/test_device_analysis.py::test_fixture_transfer_manifest_rule_fires": ["tests/test_torch_device_analysis.py::test_fixture_transfer_manifest_rule_fires"],
    "tests/test_device_analysis.py::test_fixture_raw_jit_rule_fires":
        ["tests/test_torch_analysis.py::test_twin_rule_fires_on_the_jax_function_names"],
    "tests/test_device_analysis.py::test_fixture_pallas_spellings_all_censused":
        ("jax-only", "tests/test_device_analysis.py:117",
         ["tests/test_torch_analysis.py::test_twin_spellings_all_censused",
          "tests/test_torch_analysis.py::test_kernel_launch_census_is_the_three_wrappers"]),
    "tests/test_device_analysis.py::test_fixture_slot_lifecycle_rule_fires": ["tests/test_torch_device_analysis.py::test_fixture_slot_lifecycle_rule_fires"],
    "tests/test_device_analysis.py::test_fixture_read_after_donate_rule_fires":
        ["tests/test_torch_analysis.py::test_twin_rule_fires_on_the_jax_function_names"],
    "tests/test_device_analysis.py::test_fixture_dispatch_under_lock_rule_fires": ["tests/test_torch_device_analysis.py::test_fixture_dispatch_under_lock_rule_fires"],
    "tests/test_device_analysis.py::test_clean_twin_trips_nothing": ["tests/test_torch_analysis.py::test_clean_twin_trips_nothing"],
    "tests/test_device_analysis.py::test_manifest_rejects_blank_why": ["tests/test_torch_device_analysis.py::test_manifest_rejects_blank_why"],
    "tests/test_device_analysis.py::test_manifest_rejects_duplicate_key": ["tests/test_torch_device_analysis.py::test_manifest_rejects_duplicate_key"],
    "tests/test_device_analysis.py::test_stale_manifest_entry_is_a_violation": ["tests/test_torch_device_analysis.py::test_stale_manifest_entry_is_a_violation"],
    "tests/test_device_analysis.py::test_checked_in_manifest_all_justified": ["tests/test_torch_device_analysis.py::test_checked_in_manifest_all_justified"],
    "tests/test_device_analysis.py::test_allowed_transfer_is_noop_when_disarmed": ["tests/test_torch_device_analysis.py::test_allowed_transfer_is_noop_when_disarmed"],
    "tests/test_device_analysis.py::test_witness_catches_seeded_unmanifested_transfer": ["tests/test_torch_device_analysis.py::test_witness_catches_seeded_unmanifested_transfer"],
    "tests/test_device_analysis.py::test_witness_rejects_unknown_scope_key": ["tests/test_torch_device_analysis.py::test_witness_rejects_unknown_scope_key"],
    "tests/test_device_analysis.py::test_retrace_witness_flags_bound_violation": ["tests/test_torch_analysis.py::test_retrace_witness_flags_bound_violation"],
    "tests/test_device_analysis.py::test_check_device_exits_zero_on_tree": ["tests/test_torch_device_analysis.py::test_check_device_exits_zero_on_tree"],
    "tests/test_device_analysis.py::test_check_partial_modes_do_not_promote_foreign_allowlist_entries": ["tests/test_torch_device_analysis.py::test_check_partial_modes_do_not_promote_foreign_allowlist_entries"],
    "tests/test_device_analysis.py::test_check_json_reports_device_sites": ["tests/test_torch_device_analysis.py::test_check_json_reports_device_sites"],
    # test_examples.py
    "tests/test_examples.py::test_example_runs": ["tests/test_torch_examples.py::test_example_runs"],
    "tests/test_examples.py::test_http_server_example_demo": ["tests/test_torch_examples.py::test_http_server_example_demo"],
    # test_fastpath_pool.py
    "tests/test_fastpath_pool.py::test_pool_reuse_no_bleed_success_then_success": ["tests/test_torch_native.py::test_pool_reuse_no_bleed_success_then_success"],
    "tests/test_fastpath_pool.py::test_pool_reuse_after_app_error": ["tests/test_torch_native.py::test_pool_reuse_after_app_error"],
    "tests/test_fastpath_pool.py::test_pool_reuse_after_timeout": ["tests/test_torch_native.py::test_pool_reuse_after_timeout"],
    "tests/test_fastpath_pool.py::test_pool_reuse_attachment_does_not_bleed": ["tests/test_torch_native.py::test_pool_reuse_attachment_does_not_bleed"],
    "tests/test_fastpath_pool.py::test_bytes_mode_round_trip": ["tests/test_torch_native.py::test_bytes_mode_round_trip"],
    "tests/test_fastpath_pool.py::test_bytes_mode_matches_pb_mode": ["tests/test_torch_native.py::test_bytes_mode_matches_pb_mode"],
    "tests/test_fastpath_pool.py::test_pooled_response_object_fully_replaced": ["tests/test_torch_native.py::test_pooled_response_object_fully_replaced"],
    "tests/test_fastpath_pool.py::test_recorder_counts_native_sync_calls_lazily": ["tests/test_torch_native.py::test_recorder_counts_native_sync_calls_lazily"],
    "tests/test_fastpath_pool.py::test_async_done_with_pooled_controller": ["tests/test_torch_native.py::test_async_done_with_pooled_controller"],
    "tests/test_fastpath_pool.py::test_pool_concurrent_churn": ["tests/test_torch_native.py::test_pool_concurrent_churn"],
    # test_h2_grpc.py
    "tests/test_h2_grpc.py::test_hpack_integers": ["tests/test_torch_h2.py::test_hpack_integers"],
    "tests/test_h2_grpc.py::test_hpack_huffman_roundtrip": ["tests/test_torch_h2.py::test_hpack_huffman_roundtrip"],
    "tests/test_h2_grpc.py::test_hpack_rfc_c3_requests_plain": ["tests/test_torch_h2.py::test_hpack_rfc_c3_requests_plain"],
    "tests/test_h2_grpc.py::test_hpack_rfc_c4_requests_huffman": ["tests/test_torch_h2.py::test_hpack_rfc_c4_requests_huffman"],
    "tests/test_h2_grpc.py::test_hpack_rfc_c6_responses_huffman_evictions": ["tests/test_torch_h2.py::test_hpack_rfc_c6_responses_huffman_evictions"],
    "tests/test_h2_grpc.py::test_hpack_encoder_dynamic_indexing": ["tests/test_torch_h2.py::test_hpack_encoder_dynamic_indexing"],
    "tests/test_h2_grpc.py::test_hpack_sensitive_never_indexed": ["tests/test_torch_h2.py::test_hpack_sensitive_never_indexed"],
    "tests/test_h2_grpc.py::test_h2_frame_pack_parse_roundtrip": ["tests/test_torch_h2.py::test_h2_frame_pack_parse_roundtrip"],
    "tests/test_h2_grpc.py::test_h2_parse_needs_more_bytes": ["tests/test_torch_h2.py::test_h2_parse_needs_more_bytes"],
    "tests/test_h2_grpc.py::test_grpc_timeout_parse": ["tests/test_torch_h2.py::test_grpc_timeout_parse"],
    "tests/test_h2_grpc.py::test_grpc_echo_e2e": ["tests/test_torch_h2.py::test_grpc_echo_e2e"],
    "tests/test_h2_grpc.py::test_grpc_multiplexed_concurrent_streams": ["tests/test_torch_h2.py::test_grpc_multiplexed_concurrent_streams"],
    "tests/test_h2_grpc.py::test_grpc_error_status_mapping": ["tests/test_torch_h2.py::test_grpc_error_status_mapping"],
    "tests/test_h2_grpc.py::test_grpc_large_payload_flow_control": ["tests/test_torch_h2.py::test_grpc_large_payload_flow_control"],
    "tests/test_h2_grpc.py::test_grpc_same_port_as_tpu_std": ["tests/test_torch_h2.py::test_grpc_same_port_as_tpu_std"],
    "tests/test_h2_grpc.py::test_real_grpcio_client_interop": ["tests/test_torch_h2.py::test_real_grpcio_client_interop"],
    "tests/test_h2_grpc.py::test_grpcio_large_response_flow_control": ["tests/test_torch_h2.py::test_grpcio_large_response_flow_control"],
    "tests/test_h2_grpc.py::test_h2_slow_handler_does_not_stall_other_streams": ["tests/test_torch_h2.py::test_h2_slow_handler_does_not_stall_other_streams"],
    "tests/test_h2_grpc.py::test_malformed_grpc_status_fails_only_that_rpc": ["tests/test_torch_h2.py::test_malformed_grpc_status_fails_only_that_rpc"],
    "tests/test_h2_grpc.py::test_goaway_graceful_drain": ["tests/test_torch_h2.py::test_goaway_graceful_drain"],
    # test_hbm_cache.py
    "tests/test_hbm_cache.py::test_store_set_get_roundtrip_device": ["tests/test_torch_hbm_cache.py::test_store_set_get_roundtrip_device"],
    "tests/test_hbm_cache.py::test_store_replace_and_delete_accounting": ["tests/test_torch_hbm_cache.py::test_store_replace_and_delete_accounting"],
    "tests/test_hbm_cache.py::test_store_lru_eviction_under_budget": ["tests/test_torch_hbm_cache.py::test_store_lru_eviction_under_budget"],
    "tests/test_hbm_cache.py::test_store_value_over_budget_refused": ["tests/test_torch_hbm_cache.py::test_store_value_over_budget_refused"],
    "tests/test_hbm_cache.py::test_store_flush": ["tests/test_torch_hbm_cache.py::test_store_flush"],
    "tests/test_hbm_cache.py::test_store_deviceref_whole_array_adopted_zero_copy": ["tests/test_torch_hbm_cache.py::test_store_deviceref_whole_array_adopted_zero_copy"],
    "tests/test_hbm_cache.py::test_store_disabled_mode_host_bytes": ["tests/test_torch_hbm_cache.py::test_store_disabled_mode_host_bytes"],
    "tests/test_hbm_cache.py::test_store_get_host_spills_device_value": ["tests/test_torch_hbm_cache.py::test_store_get_host_spills_device_value"],
    "tests/test_hbm_cache.py::test_store_get_many_fused_same_length": ["tests/test_torch_hbm_cache.py::test_store_get_many_fused_same_length"],
    "tests/test_hbm_cache.py::test_store_get_many_mixed_lengths_not_fused": ["tests/test_torch_hbm_cache.py::test_store_get_many_mixed_lengths_not_fused"],
    "tests/test_hbm_cache.py::test_chaos_cache_lookup_drop_forces_miss": ["tests/test_torch_hbm_cache.py::test_chaos_cache_lookup_drop_forces_miss"],
    "tests/test_hbm_cache.py::test_chaos_cache_lookup_delay_is_bounded_straggler": ["tests/test_torch_hbm_cache.py::test_chaos_cache_lookup_delay_is_bounded_straggler"],
    "tests/test_hbm_cache.py::test_ring_golden_positions_and_owners": ["tests/test_torch_hbm_cache.py::test_ring_golden_positions_and_owners"],
    "tests/test_hbm_cache.py::test_ring_is_pure_function_of_member_set": ["tests/test_torch_hbm_cache.py::test_ring_is_pure_function_of_member_set"],
    "tests/test_hbm_cache.py::test_ring_deterministic_exclusion_failover": ["tests/test_torch_hbm_cache.py::test_ring_deterministic_exclusion_failover"],
    "tests/test_hbm_cache.py::test_mesh_locality_without_coords_degrades_to_plain_ring": ["tests/test_torch_hbm_cache.py::test_mesh_locality_without_coords_degrades_to_plain_ring"],
    "tests/test_hbm_cache.py::test_mesh_locality_prefers_same_slice_replicas": ["tests/test_torch_hbm_cache.py::test_mesh_locality_prefers_same_slice_replicas"],
    "tests/test_hbm_cache.py::test_mesh_locality_spills_only_when_locals_shed_or_excluded": ["tests/test_torch_hbm_cache.py::test_mesh_locality_spills_only_when_locals_shed_or_excluded"],
    "tests/test_hbm_cache.py::test_mesh_locality_probe_revival_decays_shed": ["tests/test_torch_hbm_cache.py::test_mesh_locality_probe_revival_decays_shed"],
    "tests/test_hbm_cache.py::test_mesh_locality_shed_saturates_and_decays": ["tests/test_torch_hbm_cache.py::test_mesh_locality_shed_saturates_and_decays"],
    "tests/test_hbm_cache.py::test_redis_get_over_ici_stays_device_resident": ["tests/test_torch_cache.py::test_redis_get_over_ici_stays_device_resident"],
    "tests/test_hbm_cache.py::test_redis_set_over_budget_is_an_error_reply": ["tests/test_torch_cache.py::test_redis_set_over_budget_is_an_error_reply"],
    "tests/test_hbm_cache.py::test_redis_dmget_fused_wire_format_over_ici": ["tests/test_torch_cache.py::test_redis_dmget_fused_wire_format_over_ici"],
    "tests/test_hbm_cache.py::test_redis_dmset_bulk_write_wire_format_over_ici": ["tests/test_torch_cache.py::test_redis_dmset_bulk_write_wire_format_over_ici"],
    "tests/test_hbm_cache.py::test_redis_get_over_tcp_spills_to_host_bytes": ["tests/test_torch_cache.py::test_redis_get_over_tcp_spills_to_host_bytes"],
    "tests/test_hbm_cache.py::test_redis_admission_shed_maps_to_eovercrowded": ["tests/test_torch_cache.py::test_redis_admission_shed_maps_to_eovercrowded"],
    "tests/test_hbm_cache.py::test_cache_channel_cluster_locality_and_roundtrip": ["tests/test_torch_hbm_cache.py::test_cache_channel_cluster_locality_and_roundtrip"],
    "tests/test_hbm_cache.py::test_cache_channel_get_many_groups_by_replica": ["tests/test_torch_hbm_cache.py::test_cache_channel_get_many_groups_by_replica"],
    "tests/test_hbm_cache.py::test_cache_channel_set_many_one_dmset_per_replica_group": ["tests/test_torch_hbm_cache.py::test_cache_channel_set_many_one_dmset_per_replica_group"],
    "tests/test_hbm_cache.py::test_cache_channel_single_replica_batch_keeps_stacked_array": ["tests/test_torch_hbm_cache.py::test_cache_channel_single_replica_batch_keeps_stacked_array"],
    "tests/test_hbm_cache.py::test_cache_channel_tier_shed_spill_probe_relocalize": ["tests/test_torch_hbm_cache.py::test_cache_channel_tier_shed_spill_probe_relocalize"],
    "tests/test_hbm_cache.py::test_cache_channel_fabric_naming_feeds_membership": ["tests/test_torch_hbm_cache.py::test_cache_channel_fabric_naming_feeds_membership"],
    "tests/test_hbm_cache.py::test_witness_ici_hit_path_zero_pulls_tcp_spill_manifested": ["tests/test_torch_hbm_cache.py::test_witness_ici_hit_path_zero_pulls_tcp_spill_manifested"],
    "tests/test_hbm_cache.py::test_witness_bulk_copy_zero_violations_ledger_balanced": ["tests/test_torch_hbm_cache.py::test_witness_bulk_copy_zero_violations_ledger_balanced"],
    # test_ici.py
    "tests/test_ici.py::test_ici_echo": ["tests/test_torch_ici_carried.py::test_ici_echo"],
    "tests/test_ici.py::test_ici_device_payload_zero_copy": ["tests/test_torch_ici_carried.py::test_ici_device_payload_zero_copy"],
    "tests/test_ici.py::test_ici_concurrent_calls": ["tests/test_torch_ici_carried.py::test_ici_concurrent_calls"],
    "tests/test_ici.py::test_ici_fault_injection": ["tests/test_torch_ici_carried.py::test_ici_fault_injection"],
    "tests/test_ici.py::test_ici_server_stop_fails_calls": ["tests/test_torch_ici_carried.py::test_ici_server_stop_fails_calls"],
    "tests/test_ici.py::test_ici_unknown_coords_fails_fast": ["tests/test_torch_ici_carried.py::test_ici_unknown_coords_fails_fast"],
    "tests/test_ici.py::test_parameter_server_over_ici": ["tests/test_torch_batching.py::test_parameter_server_over_ici"],
    "tests/test_ici.py::test_ici_transmit_copies_buffer": ["tests/test_torch_ici_carried.py::test_ici_transmit_copies_buffer"],
    "tests/test_ici.py::test_ici_zero_copy_mode_moves_reference": ["tests/test_torch_ici_carried.py::test_ici_zero_copy_mode_moves_reference"],
    "tests/test_ici.py::test_transmit_array_shapes_and_content": ["tests/test_torch_ici_carried.py::test_transmit_array_shapes_and_content"],
    "tests/test_ici.py::test_ici_receive_window_backpressure": ["tests/test_torch_ici_carried.py::test_ici_receive_window_backpressure"],
    "tests/test_ici.py::test_receive_window_released_when_port_closes_mid_batch": ["tests/test_torch_ici_carried.py::test_receive_window_released_when_port_closes_mid_batch"],
    # test_ici_pipeline.py
    "tests/test_ici_pipeline.py::test_plan_chunks_one_byte_tail": ["tests/test_torch_ici_pipeline.py::test_plan_chunks_one_byte_tail"],
    "tests/test_ici_pipeline.py::test_chunk_views_one_byte_tail_reassembles": ["tests/test_torch_ici_pipeline.py::test_chunk_views_one_byte_tail_reassembles"],
    "tests/test_ici_pipeline.py::test_plan_row_chunks_alignment": ["tests/test_torch_ici_pipeline.py::test_plan_row_chunks_alignment"],
    "tests/test_ici_pipeline.py::test_chunked_checksum_equals_whole_frame_interpret": ["tests/test_torch_ici_pipeline.py::test_chunked_checksum_equals_whole_frame_interpret"],
    "tests/test_ici_pipeline.py::test_per_chunk_kernel_chain_matches_whole_frame": ["tests/test_torch_ici_pipeline.py::test_per_chunk_kernel_chain_matches_whole_frame"],
    "tests/test_ici_pipeline.py::test_pipelined_chunked_echo_content_and_fresh_buffer": ["tests/test_torch_ici_pipeline.py::test_pipelined_chunked_echo_content_and_fresh_buffer"],
    "tests/test_ici_pipeline.py::test_fused_chunked_echo_content": ["tests/test_torch_ici_pipeline.py::test_fused_chunked_echo_content"],
    "tests/test_ici_pipeline.py::test_chunk_fault_releases_window_and_surfaces_one_error": ["tests/test_torch_ici_pipeline.py::test_chunk_fault_releases_window_and_surfaces_one_error"],
    "tests/test_ici_pipeline.py::test_chunk_fault_fires_under_fused_mode_too": ["tests/test_torch_ici_pipeline.py::test_chunk_fault_fires_under_fused_mode_too"],
    "tests/test_ici_pipeline.py::test_send_batch_single_wake_in_order": ["tests/test_torch_ici_pipeline.py::test_send_batch_single_wake_in_order"],
    "tests/test_ici_pipeline.py::test_send_batch_window_overflow_fails_frames_individually": ["tests/test_torch_ici_pipeline.py::test_send_batch_window_overflow_fails_frames_individually"],
    "tests/test_ici_pipeline.py::test_delivery_burst_defers_consumer_wake": ["tests/test_torch_ici_pipeline.py::test_delivery_burst_defers_consumer_wake"],
    "tests/test_ici_pipeline.py::test_delivery_burst_bulk_frame_bypasses_capture": ["tests/test_torch_ici_pipeline.py::test_delivery_burst_bulk_frame_bypasses_capture"],
    "tests/test_ici_pipeline.py::test_execute_batch_refused_after_stop_and_credits_released": ["tests/test_torch_ici_pipeline.py::test_execute_batch_refused_after_stop_and_credits_released"],
    "tests/test_ici_pipeline.py::test_close_racing_send_reports_connection_failure_not_backpressure": ["tests/test_torch_ici_pipeline.py::test_close_racing_send_reports_connection_failure_not_backpressure"],
    "tests/test_ici_pipeline.py::test_execution_queue_execute_batch_orders_and_drains": ["tests/test_torch_ici_pipeline.py::test_execution_queue_execute_batch_orders_and_drains"],
    "tests/test_ici_pipeline.py::test_staging_ring_bookkeeping": ["tests/test_torch_ici.py::test_staging_ring_bookkeeping"],
    "tests/test_ici_pipeline.py::test_pipelined_ring_reaches_zero_alloc_steady_state": ["tests/test_torch_ici.py::test_pipelined_ring_reaches_zero_alloc_steady_state"],
    "tests/test_ici_pipeline.py::test_pallas_dma_checksum_equals_pr4_kernels_interpret": ["tests/test_torch_ici_pipeline.py::test_pallas_dma_checksum_equals_pr4_kernels_interpret"],
    "tests/test_ici_pipeline.py::test_pallas_one_byte_wire_tail_survives_pallas_mode": ["tests/test_torch_ici_pipeline.py::test_pallas_one_byte_wire_tail_survives_pallas_mode"],
    "tests/test_ici_pipeline.py::test_pallas_mode_echo_content_and_fresh_buffer": ["tests/test_torch_ici_pipeline.py::test_pallas_mode_echo_content_and_fresh_buffer"],
    "tests/test_ici_pipeline.py::test_chunk_fault_fires_under_pallas_mode_too": ["tests/test_torch_ici_pipeline.py::test_chunk_fault_fires_under_pallas_mode_too"],
    "tests/test_ici_pipeline.py::test_pallas_ring_slot_recycles_to_allocation_free_steady_state": ["tests/test_torch_ici_pipeline.py::test_pallas_ring_slot_recycles_to_allocation_free_steady_state"],
    "tests/test_ici_pipeline.py::test_pallas_stacked_transmit_coalesces_same_shape_segments": ["tests/test_torch_ici_pipeline.py::test_pallas_stacked_transmit_coalesces_same_shape_segments"],
    # test_iobuf.py
    "tests/test_iobuf.py::test_append_and_size": ["tests/test_torch_iobuf.py::test_append_and_size"],
    "tests/test_iobuf.py::test_append_spanning_blocks": ["tests/test_torch_iobuf.py::test_append_spanning_blocks"],
    "tests/test_iobuf.py::test_cutn_zero_copy_refs": ["tests/test_torch_iobuf.py::test_cutn_zero_copy_refs"],
    "tests/test_iobuf.py::test_pop_front_back": ["tests/test_torch_iobuf.py::test_pop_front_back"],
    "tests/test_iobuf.py::test_append_iobuf_shares_refs": ["tests/test_torch_iobuf.py::test_append_iobuf_shares_refs"],
    "tests/test_iobuf.py::test_device_arrays_raises_on_split_segment": ["tests/test_torch_iobuf.py::test_device_arrays_raises_on_split_segment"],
    "tests/test_iobuf.py::test_user_data_zero_copy": ["tests/test_torch_iobuf.py::test_user_data_zero_copy"],
    "tests/test_iobuf.py::test_fetch_and_cutter": ["tests/test_torch_iobuf.py::test_fetch_and_cutter"],
    "tests/test_iobuf.py::test_copy_to_with_pos": ["tests/test_torch_iobuf.py::test_copy_to_with_pos"],
    "tests/test_iobuf.py::test_socket_io_roundtrip": ["tests/test_torch_iobuf.py::test_socket_io_roundtrip"],
    "tests/test_iobuf.py::test_device_ref_lazy_materialization": ["tests/test_torch_iobuf.py::test_device_ref_lazy_materialization"],
    "tests/test_iobuf.py::test_device_ref_survives_cut": ["tests/test_torch_iobuf.py::test_device_ref_survives_cut"],
    "tests/test_iobuf.py::test_swap_and_clear": ["tests/test_torch_iobuf.py::test_swap_and_clear"],
    # test_legacy_protocols.py
    "tests/test_legacy_protocols.py::test_hulu_e2e": ["tests/test_torch_legacy.py::test_hulu_e2e"],
    "tests/test_legacy_protocols.py::test_hulu_frame_layout": ["tests/test_torch_legacy.py::test_hulu_frame_layout"],
    "tests/test_legacy_protocols.py::test_sofa_e2e": ["tests/test_torch_legacy.py::test_sofa_e2e"],
    "tests/test_legacy_protocols.py::test_sofa_frame_layout": ["tests/test_torch_legacy.py::test_sofa_frame_layout"],
    "tests/test_legacy_protocols.py::test_sofa_unknown_method_fails": ["tests/test_torch_legacy.py::test_sofa_unknown_method_fails"],
    "tests/test_legacy_protocols.py::test_nshead_raw_service": ["tests/test_torch_legacy.py::test_nshead_raw_service"],
    "tests/test_legacy_protocols.py::test_nova_e2e": ["tests/test_torch_legacy.py::test_nova_e2e"],
    "tests/test_legacy_protocols.py::test_public_pbrpc_e2e": ["tests/test_torch_legacy.py::test_public_pbrpc_e2e"],
    "tests/test_legacy_protocols.py::test_esp_e2e": ["tests/test_torch_legacy.py::test_esp_e2e"],
    "tests/test_legacy_protocols.py::test_ubrpc_e2e": ["tests/test_torch_legacy.py::test_ubrpc_e2e"],
    "tests/test_legacy_protocols.py::test_nshead_mcpack_e2e": ["tests/test_torch_legacy.py::test_nshead_mcpack_e2e"],
    # test_media_remux.py
    "tests/test_media_remux.py::test_flv_golden_bytes": ["tests/test_torch_media.py::test_flv_golden_bytes"],
    "tests/test_media_remux.py::test_flv_roundtrip_with_extended_timestamp": ["tests/test_torch_media.py::test_flv_roundtrip_with_extended_timestamp"],
    "tests/test_media_remux.py::test_flv_reader_incremental_and_errors": ["tests/test_torch_media.py::test_flv_reader_incremental_and_errors"],
    "tests/test_media_remux.py::test_crc32_mpeg_known_vector": ["tests/test_torch_media.py::test_crc32_mpeg_known_vector"],
    "tests/test_media_remux.py::test_pat_golden_bytes": ["tests/test_torch_media.py::test_pat_golden_bytes"],
    "tests/test_media_remux.py::test_pmt_lists_h264_and_aac": ["tests/test_torch_media.py::test_pmt_lists_h264_and_aac"],
    "tests/test_media_remux.py::test_mux_pes_packetization_and_pts": ["tests/test_torch_media.py::test_mux_pes_packetization_and_pts"],
    "tests/test_media_remux.py::test_avcc_to_annexb_and_adts": ["tests/test_torch_media.py::test_avcc_to_annexb_and_adts"],
    "tests/test_media_remux.py::test_hls_segmenter_end_to_end": ["tests/test_torch_media.py::test_hls_segmenter_end_to_end"],
    "tests/test_media_remux.py::test_hls_audio_only_stream": ["tests/test_torch_media.py::test_hls_audio_only_stream"],
    "tests/test_media_remux.py::test_media_gateway_over_real_rtmp": ["tests/test_torch_media.py::test_media_gateway_over_real_rtmp"],
    "tests/test_media_remux.py::test_media_gateway_bounded_streams": ["tests/test_torch_media.py::test_media_gateway_bounded_streams"],
    "tests/test_media_remux.py::test_flv_writer_rejects_oversized_tag": ["tests/test_torch_media.py::test_flv_writer_rejects_oversized_tag"],
    "tests/test_media_remux.py::test_adts_rejects_oversized_and_reserved": ["tests/test_torch_media.py::test_adts_rejects_oversized_and_reserved"],
    "tests/test_media_remux.py::test_hls_audio_only_pmt_declares_audio_pcr": ["tests/test_torch_media.py::test_hls_audio_only_pmt_declares_audio_pcr"],
    "tests/test_media_remux.py::test_hls_late_audio_header_forces_segment_cut": ["tests/test_torch_media.py::test_hls_late_audio_header_forces_segment_cut"],
    # test_memcache.py
    "tests/test_memcache.py::test_pack_get_bytes": ["tests/test_torch_memcache.py::test_pack_get_bytes"],
    "tests/test_memcache.py::test_pack_set_bytes": ["tests/test_torch_memcache.py::test_pack_set_bytes"],
    "tests/test_memcache.py::test_pack_incr_bytes": ["tests/test_torch_memcache.py::test_pack_incr_bytes"],
    "tests/test_memcache.py::test_memcache_client_end_to_end": ["tests/test_torch_memcache.py::test_memcache_client_end_to_end"],
    "tests/test_memcache.py::test_memcache_concurrent_pipelining": ["tests/test_torch_memcache.py::test_memcache_concurrent_pipelining"],
    "tests/test_memcache.py::test_memcache_server_get_set_delete_flush_roundtrip": ["tests/test_torch_memcache.py::test_memcache_server_get_set_delete_flush_roundtrip"],
    "tests/test_memcache.py::test_memcache_server_hostile_bytes_corpus": ["tests/test_torch_memcache.py::test_memcache_server_hostile_bytes_corpus"],
    "tests/test_memcache.py::test_memcache_device_value_path_over_ici": ["tests/test_torch_memcache.py::test_memcache_device_value_path_over_ici"],
    "tests/test_memcache.py::test_memcache_and_redis_fronts_share_one_store": ["tests/test_torch_memcache.py::test_memcache_and_redis_fronts_share_one_store"],
    "tests/test_memcache.py::test_memcache_admission_shed_returns_busy_status": ["tests/test_torch_memcache.py::test_memcache_admission_shed_returns_busy_status"],
    # test_native_multiproto.py
    "tests/test_native_multiproto.py::test_native_http_echo_and_python_fallback": ["tests/test_torch_native.py::test_native_http_echo_and_python_fallback"],
    "tests/test_native_multiproto.py::test_native_redis_kv_and_fallback": ["tests/test_torch_native.py::test_native_redis_kv_and_fallback"],
    "tests/test_native_multiproto.py::test_redis_pipelined_batch": ["tests/test_torch_native.py::test_redis_pipelined_batch"],
    "tests/test_native_multiproto.py::test_tpu_std_coexists_on_multiproto_port": ["tests/test_torch_native.py::test_tpu_std_coexists_on_multiproto_port"],
    "tests/test_native_multiproto.py::test_http_connection_close_honored_on_native_path": ["tests/test_torch_native.py::test_http_connection_close_honored_on_native_path"],
    "tests/test_native_multiproto.py::test_garbage_on_multiproto_port_is_dropped": ["tests/test_torch_native.py::test_garbage_on_multiproto_port_is_dropped"],
    "tests/test_native_multiproto.py::test_native_http_bench_generator": ["tests/test_torch_native.py::test_native_http_bench_generator"],
    "tests/test_native_multiproto.py::test_native_redis_bench_generator": ["tests/test_torch_native.py::test_native_redis_bench_generator"],
    "tests/test_native_multiproto.py::test_redis_reply_order_native_and_fallback_interleaved": ["tests/test_torch_native.py::test_redis_reply_order_native_and_fallback_interleaved"],
    "tests/test_native_multiproto.py::test_mixed_protocol_churn_stress": ["tests/test_torch_native.py::test_mixed_protocol_churn_stress"],
    "tests/test_native_multiproto.py::test_native_framers_survive_hostile_bytes": ["tests/test_torch_native.py::test_native_framers_survive_hostile_bytes"],
    "tests/test_native_multiproto.py::test_http10_defaults_to_close_on_native_path": ["tests/test_torch_native.py::test_http10_defaults_to_close_on_native_path"],
    "tests/test_native_multiproto.py::test_http10_keep_alive_optin_honored": ["tests/test_torch_native.py::test_http10_keep_alive_optin_honored"],
    "tests/test_native_multiproto.py::test_http11_default_keep_alive_unchanged": ["tests/test_torch_native.py::test_http11_default_keep_alive_unchanged"],
    "tests/test_native_multiproto.py::test_http_reply_order_native_and_fallback_interleaved": ["tests/test_torch_native.py::test_http_reply_order_native_and_fallback_interleaved"],
    # test_observability_depth.py
    "tests/test_observability_depth.py::test_contention_profile_nonempty_under_contention": ["tests/test_torch_observability_depth.py::test_contention_profile_nonempty_under_contention"],
    "tests/test_observability_depth.py::test_hotspots_contention_page": ["tests/test_torch_observability_depth.py::test_hotspots_contention_page"],
    "tests/test_observability_depth.py::test_hotspots_heap_growth_pages": ["tests/test_torch_observability_depth.py::test_hotspots_heap_growth_pages"],
    "tests/test_observability_depth.py::test_rpcz_sqlite_persistence": ["tests/test_torch_observability_depth.py::test_rpcz_sqlite_persistence"],
    "tests/test_observability_depth.py::test_server_span_phase_stamps_and_response_size": ["tests/test_torch_observability_depth.py::test_server_span_phase_stamps_and_response_size"],
    "tests/test_observability_depth.py::test_fanout_trace_tree_and_latency_breakdown": ["tests/test_torch_observability_depth.py::test_fanout_trace_tree_and_latency_breakdown", "tests/test_torch_repairs.py::test_metrics_page_folds_each_phase_recorder_once", "tests/test_torch_repairs.py::test_phase_stats_print_the_reference_values_for_a_seeded_recorder"],
    "tests/test_observability_depth.py::test_http_trace_propagation": ["tests/test_torch_observability_depth.py::test_http_trace_propagation"],
    "tests/test_observability_depth.py::test_latency_breakdown_method_cap_collapses_to_other": ["tests/test_torch_observability_depth.py::test_latency_breakdown_method_cap_collapses_to_other"],
    "tests/test_observability_depth.py::test_spandb_persistence_evicted_in_start_order": ["tests/test_torch_observability_depth.py::test_spandb_persistence_evicted_in_start_order"],
    "tests/test_observability_depth.py::test_rpcz_page_merges_persisted": ["tests/test_torch_observability_depth.py::test_rpcz_page_merges_persisted"],
    # test_parallel.py
    "tests/test_parallel.py::test_mesh_and_topology": ["tests/test_torch_parallel.py::test_mesh_and_topology"],
    "tests/test_parallel.py::test_parallel_merge_psum":
        ["tests/test_torch_parallel.py::test_parallel_merge_within_tolerance_of_jax",
         "tests/test_torch_parallel.py::test_psum_is_bit_equal_to_the_chip_order_sum"],
    "tests/test_parallel.py::test_all_gather_merge":
        ["tests/test_torch_parallel.py::test_all_gather_byte_equal_to_jax"],
    "tests/test_parallel.py::test_ring_stream":
        ["tests/test_torch_parallel.py::test_ring_stream_byte_equal_to_jax"],
    "tests/test_parallel.py::test_partition_reshard":
        ["tests/test_torch_parallel.py::test_partition_reshard_byte_equal_to_jax"],
    "tests/test_parallel.py::test_hedged_first_valid":
        ["tests/test_torch_parallel.py::test_hedged_first_valid_byte_equal_to_jax"],
    "tests/test_parallel.py::test_training_step_sharded":
        ["tests/test_torch_parallel.py::test_training_step_keeps_its_shardings_and_learns",
         "tests/test_torch_parallel.py::test_training_step_matches_jax_from_the_carried_state"],
    "tests/test_parallel.py::test_graft_entry_single":
        ("jax-only", "tests/test_parallel.py:96"),
    "tests/test_parallel.py::test_graft_dryrun_multichip":
        ("jax-only", "tests/test_parallel.py:99"),
    "tests/test_parallel.py::test_graft_dryrun_survives_foreign_backend_env":
        ("jax-only", "tests/test_parallel.py:144"),
    "tests/test_parallel.py::test_graft_dryrun_survives_pythonpath_sitecustomize":
        ("jax-only", "tests/test_parallel.py:187"),
    "tests/test_parallel.py::test_ops_merge": ["tests/test_torch_parallel_carried.py::test_ops_merge"],
    # test_profiling.py
    "tests/test_profiling.py::test_hbm_account_contract_and_gate": ["tests/test_torch_profiling.py::test_hbm_account_contract_and_gate"],
    "tests/test_profiling.py::test_cache_store_accounting_exact_across_evict_replace_flush": ["tests/test_torch_profiling.py::test_cache_store_accounting_exact_across_evict_replace_flush"],
    "tests/test_profiling.py::test_staging_ring_accounting_acquire_release_evict": ["tests/test_torch_profiling.py::test_staging_ring_accounting_acquire_release_evict"],
    "tests/test_profiling.py::test_ps_params_accounting_exact_put_replace_delete": ["tests/test_torch_profiling.py::test_ps_params_accounting_exact_put_replace_delete"],
    "tests/test_profiling.py::test_hbm_profile_dark_bucket_under_witness": ["tests/test_torch_profiling.py::test_hbm_profile_dark_bucket_under_witness"],
    "tests/test_profiling.py::test_hotspots_pages_respond": ["tests/test_torch_profiling.py::test_hotspots_pages_respond"],
    "tests/test_profiling.py::test_hbm_growth_page_diffs_across_forced_eviction": ["tests/test_torch_profiling.py::test_hbm_growth_page_diffs_across_forced_eviction"],
    "tests/test_profiling.py::test_hbm_page_rebase_resets_dark_horizon": ["tests/test_torch_profiling.py::test_hbm_page_rebase_resets_dark_horizon"],
    "tests/test_profiling.py::test_kernel_section_counters_and_gate": ["tests/test_torch_profiling.py::test_kernel_section_counters_and_gate"],
    "tests/test_profiling.py::test_concurrent_capture_while_serving": ["tests/test_torch_profiling.py::test_concurrent_capture_while_serving"],
    "tests/test_profiling.py::test_chaos_profile_capture_drop_then_recovery": ["tests/test_torch_profiling.py::test_chaos_profile_capture_drop_then_recovery"],
    "tests/test_profiling.py::test_chaos_profile_capture_delay_stretches_start": ["tests/test_torch_profiling.py::test_chaos_profile_capture_delay_stretches_start"],
    "tests/test_profiling.py::test_occupancy_storm_nonzero_queue_wait_and_steals": ["tests/test_torch_profiling.py::test_occupancy_storm_nonzero_queue_wait_and_steals"],
    "tests/test_profiling.py::test_occupancy_gate_stops_sampling": ["tests/test_torch_profiling.py::test_occupancy_gate_stops_sampling"],
    "tests/test_profiling.py::test_latency_breakdown_renders_device_phase_for_batched_forward": ["tests/test_torch_profiling.py::test_latency_breakdown_renders_device_phase_for_batched_forward"],
    # test_protocol_matrix.py
    "tests/test_protocol_matrix.py::test_sync_echo": ["tests/test_torch_protocol_matrix.py::test_sync_echo"],
    "tests/test_protocol_matrix.py::test_async_echo": ["tests/test_torch_protocol_matrix.py::test_async_echo"],
    "tests/test_protocol_matrix.py::test_timeout": ["tests/test_torch_protocol_matrix.py::test_timeout"],
    "tests/test_protocol_matrix.py::test_server_fail_propagates": ["tests/test_torch_protocol_matrix.py::test_server_fail_propagates"],
    "tests/test_protocol_matrix.py::test_late_response_never_binds_to_new_rpc": ["tests/test_torch_protocol_matrix.py::test_late_response_never_binds_to_new_rpc"],
    # test_replication.py
    "tests/test_replication.py::test_lease_tag_grammar_and_coexistence_with_partition_tags": ["tests/test_torch_replication.py::test_lease_tag_grammar_and_coexistence_with_partition_tags"],
    "tests/test_replication.py::test_two_candidate_race_resolves_to_one_leader_per_epoch": ["tests/test_torch_replication.py::test_two_candidate_race_resolves_to_one_leader_per_epoch"],
    "tests/test_replication.py::test_quorum_write_replicates_to_every_serving_store": ["tests/test_torch_replication.py::test_quorum_write_replicates_to_every_serving_store"],
    "tests/test_replication.py::test_expired_lease_fences_every_old_leader_write": ["tests/test_torch_replication.py::test_expired_lease_fences_every_old_leader_write"],
    "tests/test_replication.py::test_lapsed_lease_never_acks_even_when_quorum_applied": ["tests/test_torch_replication.py::test_lapsed_lease_never_acks_even_when_quorum_applied"],
    "tests/test_replication.py::test_rejoining_replica_serves_only_after_repair": ["tests/test_torch_replication.py::test_rejoining_replica_serves_only_after_repair"],
    "tests/test_replication.py::test_seeded_replay_ack_drop_is_durable_but_uncounted": ["tests/test_torch_replication.py::test_seeded_replay_ack_drop_is_durable_but_uncounted"],
    "tests/test_replication.py::test_seeded_replay_lease_drop_forces_next_candidate": ["tests/test_torch_replication.py::test_seeded_replay_lease_drop_forces_next_candidate"],
    "tests/test_replication.py::test_rf1_collapses_to_unreplicated_path": ["tests/test_torch_sharded_ps.py::test_rf1_collapses_to_unreplicated_path"],
    "tests/test_replication.py::test_replicated_channel_put_get_delete_semantics": ["tests/test_torch_sharded_ps.py::test_replicated_channel_put_get_delete_semantics"],
    "tests/test_replication.py::test_hedged_read_covers_slow_replicas_and_counts": ["tests/test_torch_sharded_ps.py::test_hedged_read_covers_slow_replicas_and_counts"],
    "tests/test_replication.py::test_leader_kill_mid_write_storm_zero_acked_write_loss": ["tests/test_torch_sharded_ps.py::test_leader_kill_mid_write_storm_zero_acked_write_loss"],
    "tests/test_replication.py::test_replicated_cache_group_quorum_and_bulk_repair": ["tests/test_torch_replication.py::test_replicated_cache_group_quorum_and_bulk_repair"],
    "tests/test_replication.py::test_replication_builtin_page_and_status_section": ["tests/test_torch_replication.py::test_replication_builtin_page_and_status_section"],
    # test_resharding.py
    "tests/test_resharding.py::test_moved_keys_exactly_equals_scheme_delta": ["tests/test_torch_resharding.py::test_moved_keys_exactly_equals_scheme_delta"],
    "tests/test_resharding.py::test_consistent_hash_ring_growth_only_moves_to_new_nodes": ["tests/test_torch_resharding.py::test_consistent_hash_ring_growth_only_moves_to_new_nodes"],
    "tests/test_resharding.py::test_epoch_tag_grammar_and_backward_compat": ["tests/test_torch_resharding.py::test_epoch_tag_grammar_and_backward_compat"],
    "tests/test_resharding.py::test_resharding_state_persists_and_resumes": ["tests/test_torch_resharding.py::test_resharding_state_persists_and_resumes"],
    "tests/test_resharding.py::test_resharding_builtin_page": ["tests/test_torch_resharding.py::test_resharding_builtin_page"],
    "tests/test_resharding.py::test_copy_faults_retry_and_corrupt_recopies": ["tests/test_torch_resharding.py::test_copy_faults_retry_and_corrupt_recopies"],
    "tests/test_resharding.py::test_cutover_drop_rolls_back_clean": ["tests/test_torch_resharding.py::test_cutover_drop_rolls_back_clean"],
    "tests/test_resharding.py::test_storm_plan_replays_deterministically": ["tests/test_torch_resharding.py::test_storm_plan_replays_deterministically"],
    "tests/test_resharding.py::test_stable_shard_lb_shed_parity_demotes_and_probes": ["tests/test_torch_resharding.py::test_stable_shard_lb_shed_parity_demotes_and_probes"],
    "tests/test_resharding.py::test_membership_flap_mid_fanout_exactly_once": ["tests/test_torch_sharded_ps.py::test_membership_flap_mid_fanout_exactly_once"],
    "tests/test_resharding.py::test_live_migration_zero_downtime_under_load": ["tests/test_torch_sharded_ps.py::test_live_migration_zero_downtime_under_load"],
    "tests/test_resharding.py::test_inflight_fanout_finishes_on_scheme_it_started_on": ["tests/test_torch_sharded_ps.py::test_inflight_fanout_finishes_on_scheme_it_started_on"],
    "tests/test_resharding.py::test_kill_source_mid_copy_completes_from_survivors": ["tests/test_torch_sharded_ps.py::test_kill_source_mid_copy_completes_from_survivors"],
    "tests/test_resharding.py::test_kill_source_mid_copy_without_copies_rolls_back": ["tests/test_torch_sharded_ps.py::test_kill_source_mid_copy_without_copies_rolls_back"],
    "tests/test_resharding.py::test_cache_migration_moves_scheme_delta_and_spilled_gets_miss_clean": ["tests/test_torch_resharding.py::test_cache_migration_moves_scheme_delta_and_spilled_gets_miss_clean"],
    "tests/test_resharding.py::test_cache_migration_bulk_collective_steps_much_less_than_keys": ["tests/test_torch_resharding.py::test_cache_migration_bulk_collective_steps_much_less_than_keys"],
    # test_ring.py
    "tests/test_ring.py::test_window_round_trip_order_and_counters": ["tests/test_torch_ring.py::test_window_round_trip_order_and_counters"],
    "tests/test_ring.py::test_pb_requests_and_app_error_semantics": ["tests/test_torch_ring.py::test_pb_requests_and_app_error_semantics"],
    "tests/test_ring.py::test_timeout_maps_to_erpctimedout": ["tests/test_torch_ring.py::test_timeout_maps_to_erpctimedout"],
    "tests/test_ring.py::test_submit_harvest_pipelined_pair": ["tests/test_torch_ring.py::test_submit_harvest_pipelined_pair"],
    "tests/test_ring.py::test_sibling_rings_share_completion_lane": ["tests/test_torch_ring.py::test_sibling_rings_share_completion_lane"],
    "tests/test_ring.py::test_interleaved_native_and_fallback_one_window": ["tests/test_torch_ring.py::test_interleaved_native_and_fallback_one_window"],
    "tests/test_ring.py::test_non_native_channel_degrades_per_call": ["tests/test_torch_ring.py::test_non_native_channel_degrades_per_call"],
    "tests/test_ring.py::test_ring_submit_drop_fails_whole_window_exactly_once": ["tests/test_torch_ring.py::test_ring_submit_drop_fails_whole_window_exactly_once"],
    "tests/test_ring.py::test_ring_submit_replay_is_deterministic": ["tests/test_torch_ring.py::test_ring_submit_replay_is_deterministic"],
    "tests/test_ring.py::test_exactly_once_under_native_partial_faults": ["tests/test_torch_ring.py::test_exactly_once_under_native_partial_faults"],
    "tests/test_ring.py::test_ring_fallback_under_socket_write_io_plan": ["tests/test_torch_ring.py::test_ring_fallback_under_socket_write_io_plan"],
    "tests/test_ring.py::test_server_ring_one_burst_per_harvested_window": ["tests/test_torch_ring.py::test_server_ring_one_burst_per_harvested_window"],
    "tests/test_ring.py::test_server_ring_pipelined_windows_keep_reply_order": ["tests/test_torch_ring.py::test_server_ring_pipelined_windows_keep_reply_order"],
    "tests/test_ring.py::test_server_ring_python_lane_rides_send_burst": ["tests/test_torch_ring.py::test_server_ring_python_lane_rides_send_burst"],
    "tests/test_ring.py::test_ring_metrics_and_status_surfaces": ["tests/test_torch_ring.py::test_ring_metrics_and_status_surfaces"],
    "tests/test_ring.py::test_server_ring_flush_drop_times_out_exactly_once": ["tests/test_torch_ring.py::test_server_ring_flush_drop_times_out_exactly_once"],
    "tests/test_ring.py::test_server_ring_recovery_under_flush_faults": ["tests/test_torch_ring.py::test_server_ring_recovery_under_flush_faults"],
    "tests/test_ring.py::test_shard_call_many_crosses_once_per_shard": ["tests/test_torch_ring.py::test_shard_call_many_crosses_once_per_shard"],
    "tests/test_ring.py::test_shard_call_many_controller_degrades_that_call_only": ["tests/test_torch_ring.py::test_shard_call_many_controller_degrades_that_call_only", "tests/test_torch_repairs.py::test_shard_call_many_fallback_keeps_each_reply_attachment"],
    "tests/test_ring.py::test_parallel_call_many_one_subwindow_per_leg": ["tests/test_torch_ring.py::test_parallel_call_many_one_subwindow_per_leg"],
    "tests/test_ring.py::test_window_reaches_micro_batcher_as_one_accumulation": ["tests/test_torch_ring.py::test_window_reaches_micro_batcher_as_one_accumulation"],
    "tests/test_ring.py::test_two_thread_concurrent_submit_harvest": ["tests/test_torch_ring.py::test_two_thread_concurrent_submit_harvest"],
    # test_rtmp.py
    "tests/test_rtmp.py::test_amf0_roundtrip": ["tests/test_torch_rtmp.py::test_amf0_roundtrip"],
    "tests/test_rtmp.py::test_amf0_wire_bytes": ["tests/test_torch_rtmp.py::test_amf0_wire_bytes"],
    "tests/test_rtmp.py::test_rtmp_connect_create_publish": ["tests/test_torch_rtmp.py::test_rtmp_connect_create_publish"],
    "tests/test_rtmp.py::test_rtmp_publish_play_relay": ["tests/test_torch_rtmp.py::test_rtmp_publish_play_relay"],
    "tests/test_rtmp.py::test_rtmp_late_joiner_gets_sequence_headers": ["tests/test_torch_rtmp.py::test_rtmp_late_joiner_gets_sequence_headers"],
    "tests/test_rtmp.py::test_rtmp_service_hooks_can_reject": ["tests/test_torch_rtmp.py::test_rtmp_service_hooks_can_reject"],
    "tests/test_rtmp.py::test_rtmp_coexists_with_rpc": ["tests/test_torch_rtmp.py::test_rtmp_coexists_with_rpc"],
    "tests/test_rtmp.py::test_rtmp_extended_timestamp_multichunk": ["tests/test_torch_rtmp.py::test_rtmp_extended_timestamp_multichunk"],
    # test_serving.py
    "tests/test_serving.py::test_kv_key_roundtrip": ["tests/test_torch_serving_carried.py::test_kv_key_roundtrip"],
    "tests/test_serving.py::test_kv_key_rejects_foreign_grammars_and_junk": ["tests/test_torch_serving_carried.py::test_kv_key_rejects_foreign_grammars_and_junk"],
    "tests/test_serving.py::test_prompt_seed_state_matches_decode_loop_init": ["tests/test_torch_serving_carried.py::test_prompt_seed_state_matches_decode_loop_init"],
    "tests/test_serving.py::test_disagg_tokens_match_monolithic_generate": ["tests/test_torch_serving.py::test_disagg_tokens_match_monolithic_generate"],
    "tests/test_serving.py::test_prefill_window_is_one_batched_execution": ["tests/test_torch_serving_carried.py::test_prefill_window_is_one_batched_execution"],
    "tests/test_serving.py::test_decode_pull_is_fused_dmget": ["tests/test_torch_serving.py::test_decode_pull_is_fused_dmget"],
    "tests/test_serving.py::test_step_log_prefill_exactly_once_across_two_migrations": ["tests/test_torch_serving.py::test_step_log_prefill_exactly_once_across_two_migrations"],
    "tests/test_serving.py::test_overloaded_replica_sheds_and_router_hops": ["tests/test_torch_serving.py::test_overloaded_replica_sheds_and_router_hops"],
    "tests/test_serving.py::test_all_replicas_dead_fails_with_erpc_code": ["tests/test_torch_serving_carried.py::test_all_replicas_dead_fails_with_erpc_code"],
    "tests/test_serving.py::test_kv_ship_drop_is_erpc_never_silent_and_epoch_complete_or_absent": ["tests/test_torch_serving.py::test_kv_ship_drop_is_erpc_never_silent_and_epoch_complete_or_absent"],
    "tests/test_serving.py::test_kv_ship_drop_at_checkpoint_falls_back_to_crash_migration": ["tests/test_torch_serving_carried.py::test_kv_ship_drop_at_checkpoint_falls_back_to_crash_migration"],
    "tests/test_serving.py::test_kv_ship_seeded_replay_identical_hit_log": ["tests/test_torch_serving_carried.py::test_kv_ship_seeded_replay_identical_hit_log"],
    "tests/test_serving.py::test_kv_ship_delay_us_stretches_not_fails": ["tests/test_torch_serving_carried.py::test_kv_ship_delay_us_stretches_not_fails"],
    "tests/test_serving.py::test_session_migrate_drop_aborts_handoff_session_stays_on_source": ["tests/test_torch_serving_carried.py::test_session_migrate_drop_aborts_handoff_session_stays_on_source"],
    "tests/test_serving.py::test_session_migrate_seeded_replay_identical_decisions": ["tests/test_torch_chaos.py::test_session_migrate_seeded_replay_identical_decisions"],
    "tests/test_serving.py::test_recovery_kill_decode_replica_under_storm": ["tests/test_torch_serving_carried.py::test_recovery_kill_decode_replica_under_storm"],
    "tests/test_serving.py::test_witness_kv_never_crosses_host_prefill_to_decode": ["tests/test_torch_serving_carried.py::test_witness_kv_never_crosses_host_prefill_to_decode"],
    "tests/test_serving.py::test_prefill_and_streamed_admit_over_rpc": ["tests/test_torch_serving.py::test_prefill_and_streamed_admit_over_rpc"],
    "tests/test_serving.py::test_unary_admit_fallback_and_missing_kv_is_erpc": ["tests/test_torch_serving_carried.py::test_unary_admit_fallback_and_missing_kv_is_erpc"],
    "tests/test_serving.py::test_sse_admit_front": ["tests/test_torch_serving_carried.py::test_sse_admit_front"],
    "tests/test_serving.py::test_serving_metrics_exposed_and_counted": ["tests/test_torch_serving_carried.py::test_serving_metrics_exposed_and_counted"],
    "tests/test_serving.py::test_serving_builtin_page_and_status_section": ["tests/test_torch_serving_carried.py::test_serving_builtin_page_and_status_section"],
    "tests/test_serving.py::test_rpcz_one_trace_joins_prefill_ship_and_hops": ["tests/test_torch_serving_carried.py::test_rpcz_one_trace_joins_prefill_ship_and_hops"],
    # test_sharded_ps.py
    "tests/test_sharded_ps.py::test_put_param_shards_eligible_matrices": ["tests/test_torch_sharded_ps.py::test_put_param_shards_eligible_matrices"],
    "tests/test_sharded_ps.py::test_sharded_forward_one_execution_one_merge_per_batch": ["tests/test_torch_sharded_ps.py::test_sharded_forward_one_execution_one_merge_per_batch"],
    "tests/test_sharded_ps.py::test_sharded_forward_matches_unsharded_bit_for_bit_semantics": ["tests/test_torch_sharded_ps_carried.py::test_sharded_forward_matches_unsharded_bit_for_bit_semantics"],
    "tests/test_sharded_ps.py::test_sharded_forward_leaves_collective_subspan": ["tests/test_torch_sharded_ps.py::test_sharded_forward_leaves_collective_subspan"],
    "tests/test_sharded_ps.py::test_collective_merge_chaos_reset_fails_only_that_group": ["tests/test_torch_sharded_ps.py::test_collective_merge_chaos_reset_fails_only_that_group"],
    "tests/test_sharded_ps.py::test_max_servable_dim_hbm_ceiling": ["tests/test_torch_sharded_ps.py::test_max_servable_dim_hbm_ceiling"],
    "tests/test_sharded_ps.py::test_shard_mapping_consistent_across_restarts": ["tests/test_torch_sharded_ps_carried.py::test_shard_mapping_consistent_across_restarts"],
    "tests/test_sharded_ps.py::test_get_put_land_exactly_one_rpc_on_owning_shard": ["tests/test_torch_sharded_ps.py::test_get_put_land_exactly_one_rpc_on_owning_shard"],
    "tests/test_sharded_ps.py::test_fanout_forward_merges_partials_in_one_burst": ["tests/test_torch_sharded_ps_carried.py::test_fanout_forward_merges_partials_in_one_burst"],
    "tests/test_sharded_ps.py::test_fanout_forward_per_leg_spans_join_one_trace": ["tests/test_torch_sharded_ps.py::test_fanout_forward_per_leg_spans_join_one_trace"],
    "tests/test_sharded_ps.py::test_dead_shard_degrades_per_combo_channel_contract": ["tests/test_torch_sharded_ps_carried.py::test_dead_shard_degrades_per_combo_channel_contract"],
    "tests/test_sharded_ps.py::test_stable_shard_lb_is_deterministic_across_instances": ["tests/test_torch_sharded_ps_carried.py::test_stable_shard_lb_is_deterministic_across_instances"],
    # test_ssl.py
    "tests/test_ssl.py::test_tls_echo_rpc": ["tests/test_torch_ssl.py::test_tls_echo_rpc"],
    "tests/test_ssl.py::test_tls_attachment_roundtrip": ["tests/test_torch_ssl.py::test_tls_attachment_roundtrip"],
    "tests/test_ssl.py::test_tls_https_builtin_page": ["tests/test_torch_ssl.py::test_tls_https_builtin_page"],
    "tests/test_ssl.py::test_tls_rejects_plaintext_client": ["tests/test_torch_ssl.py::test_tls_rejects_plaintext_client"],
    "tests/test_ssl.py::test_tls_hostname_verification_failure": ["tests/test_torch_ssl.py::test_tls_hostname_verification_failure"],
    "tests/test_ssl.py::test_tls_mutual_auth": ["tests/test_torch_ssl.py::test_tls_mutual_auth"],
    "tests/test_ssl.py::test_tls_dcn_cross_process_echo": ["tests/test_torch_dcn.py::test_tls_dcn_cross_process_echo"],
    "tests/test_ssl.py::test_ssl_config_not_shared_across_channels": ["tests/test_torch_ssl.py::test_ssl_config_not_shared_across_channels"],
    "tests/test_ssl.py::test_grpc_over_tls": ["tests/test_torch_h2.py::test_grpc_over_tls"],
    "tests/test_ssl.py::test_real_grpcio_client_over_tls": ["tests/test_torch_h2.py::test_real_grpcio_client_over_tls"],
    "tests/test_ssl.py::test_alpns_comma_string_form": ["tests/test_torch_ssl.py::test_alpns_comma_string_form"],
    # test_streaming_generate.py
    "tests/test_streaming_generate.py::test_loop_generates_deterministic_tokens": ["tests/test_torch_serving.py::test_loop_generates_deterministic_tokens"],
    "tests/test_streaming_generate.py::test_row_admitted_mid_stream_shares_fused_steps": ["tests/test_torch_serving.py::test_row_admitted_mid_stream_shares_fused_steps"],
    "tests/test_streaming_generate.py::test_cancel_frees_slot_within_one_step": ["tests/test_torch_serving.py::test_cancel_frees_slot_within_one_step"],
    "tests/test_streaming_generate.py::test_per_row_emit_failure_never_poisons_step_mates": ["tests/test_torch_serving.py::test_per_row_emit_failure_never_poisons_step_mates"],
    "tests/test_streaming_generate.py::test_streamed_generation_roundtrip": ["tests/test_torch_serving.py::test_streamed_generation_roundtrip"],
    "tests/test_streaming_generate.py::test_unary_fallback_matches_streamed_tokens": ["tests/test_torch_serving.py::test_unary_fallback_matches_streamed_tokens"],
    "tests/test_streaming_generate.py::test_client_cancel_mid_stream_frees_slot": ["tests/test_torch_serving.py::test_client_cancel_mid_stream_frees_slot"],
    "tests/test_streaming_generate.py::test_slow_consumer_evicted_not_blocking_loop": ["tests/test_torch_streaming_generate.py::test_slow_consumer_evicted_not_blocking_loop"],
    "tests/test_streaming_generate.py::test_sse_tokens_observed_progressively": ["tests/test_torch_streaming_generate.py::test_sse_tokens_observed_progressively"],
    "tests/test_streaming_generate.py::test_sse_wire_content_type": ["tests/test_torch_streaming_generate.py::test_sse_wire_content_type"],
    "tests/test_streaming_generate.py::test_aborted_generation_surfaces_as_stream_failure": ["tests/test_torch_streaming_generate.py::test_aborted_generation_surfaces_as_stream_failure"],
    # test_streaming_subsystem.py
    "tests/test_streaming_subsystem.py::test_parse_partial_magic_prefix_waits": ["tests/test_torch_streaming_subsystem.py::test_parse_partial_magic_prefix_waits"],
    "tests/test_streaming_subsystem.py::test_parse_non_magic_tries_others": ["tests/test_torch_streaming_subsystem.py::test_parse_non_magic_tries_others"],
    "tests/test_streaming_subsystem.py::test_parse_truncated_header_with_magic_waits": ["tests/test_torch_streaming_subsystem.py::test_parse_truncated_header_with_magic_waits"],
    "tests/test_streaming_subsystem.py::test_parse_bad_type_byte_kills_connection": ["tests/test_torch_streaming_subsystem.py::test_parse_bad_type_byte_kills_connection"],
    "tests/test_streaming_subsystem.py::test_parse_oversized_length_kills_connection": ["tests/test_torch_streaming_subsystem.py::test_parse_oversized_length_kills_connection"],
    "tests/test_streaming_subsystem.py::test_parse_roundtrip_all_frame_types": ["tests/test_torch_streaming_subsystem.py::test_parse_roundtrip_all_frame_types"],
    "tests/test_streaming_subsystem.py::test_unknown_stream_data_part_gets_rst": ["tests/test_torch_streaming_subsystem.py::test_unknown_stream_data_part_gets_rst"],
    "tests/test_streaming_subsystem.py::test_stream_ids_namespaced_per_direction": ["tests/test_torch_streaming_subsystem.py::test_stream_ids_namespaced_per_direction"],
    "tests/test_streaming_subsystem.py::test_stream_id_collision_regression": ["tests/test_torch_streaming_subsystem.py::test_stream_id_collision_regression"],
    "tests/test_streaming_subsystem.py::test_writer_blocks_on_slow_consumer_and_resumes": ["tests/test_torch_streaming_subsystem.py::test_writer_blocks_on_slow_consumer_and_resumes"],
    "tests/test_streaming_subsystem.py::test_feedback_batching_min_buf_size": ["tests/test_torch_streaming_subsystem.py::test_feedback_batching_min_buf_size"],
    "tests/test_streaming_subsystem.py::test_segmented_large_message_survives_small_window": ["tests/test_torch_streaming_subsystem.py::test_segmented_large_message_survives_small_window"],
    "tests/test_streaming_subsystem.py::test_half_close_handshake": ["tests/test_torch_streaming_subsystem.py::test_half_close_handshake"],
    "tests/test_streaming_subsystem.py::test_idle_timeout_fails_stream": ["tests/test_torch_streaming_subsystem.py::test_idle_timeout_fails_stream"],
    "tests/test_streaming_subsystem.py::test_chaos_dropped_feedback_cannot_deadlock_blocked_writer": ["tests/test_torch_streaming_subsystem.py::test_chaos_dropped_feedback_cannot_deadlock_blocked_writer"],
    "tests/test_streaming_subsystem.py::test_chaos_stream_reset_spares_the_socket": ["tests/test_torch_streaming_subsystem.py::test_chaos_stream_reset_spares_the_socket"],
    "tests/test_streaming_subsystem.py::test_chaos_stream_frame_replay_is_deterministic": ["tests/test_torch_streaming_subsystem.py::test_chaos_stream_frame_replay_is_deterministic"],
    "tests/test_streaming_subsystem.py::test_stream_metrics_and_status_page": ["tests/test_torch_streaming_subsystem.py::test_stream_metrics_and_status_page"],
    "tests/test_streaming_subsystem.py::test_stream_rpcz_span_joined_to_rpc_trace": ["tests/test_torch_streaming_subsystem.py::test_stream_rpcz_span_joined_to_rpc_trace"],
    "tests/test_streaming_subsystem.py::test_stream_over_ici_device_payload": ["tests/test_torch_cache.py::test_stream_over_ici_device_payload"],
    "tests/test_streaming_subsystem.py::test_oversized_single_frame_admitted_when_window_empty": ["tests/test_torch_streaming_subsystem.py::test_oversized_single_frame_admitted_when_window_empty", "tests/test_torch_repairs.py::test_a_stream_never_writes_to_the_next_life_of_its_socket"],
    "tests/test_streaming_subsystem.py::test_default_options_large_host_write_segments_within_window": ["tests/test_torch_streaming_subsystem.py::test_default_options_large_host_write_segments_within_window"],
    "tests/test_streaming_subsystem.py::test_segmented_abort_mid_message_resets_stream": ["tests/test_torch_streaming_subsystem.py::test_segmented_abort_mid_message_resets_stream"],
    "tests/test_streaming_subsystem.py::test_unknown_stream_rst_routes_back_to_writer": ["tests/test_torch_streaming_subsystem.py::test_unknown_stream_rst_routes_back_to_writer"],
    "tests/test_streaming_subsystem.py::test_progressive_attachment_backlog_probe": ["tests/test_torch_streaming_subsystem.py::test_progressive_attachment_backlog_probe"],
    # test_thrift_mongo.py
    "tests/test_thrift_mongo.py::test_thrift_pack_is_strict_binary_framed": ["tests/test_torch_thrift_mongo.py::test_thrift_pack_is_strict_binary_framed"],
    "tests/test_thrift_mongo.py::test_thrift_client_server_e2e": ["tests/test_torch_thrift_mongo.py::test_thrift_client_server_e2e"],
    "tests/test_thrift_mongo.py::test_thrift_unknown_method_is_exception": ["tests/test_torch_thrift_mongo.py::test_thrift_unknown_method_is_exception"],
    "tests/test_thrift_mongo.py::test_bson_roundtrip": ["tests/test_torch_thrift_mongo.py::test_bson_roundtrip"],
    "tests/test_thrift_mongo.py::test_mongo_op_msg_ping": ["tests/test_torch_thrift_mongo.py::test_mongo_op_msg_ping"],
    "tests/test_thrift_mongo.py::test_mongo_op_msg_echo_command": ["tests/test_torch_thrift_mongo.py::test_mongo_op_msg_echo_command"],
    "tests/test_thrift_mongo.py::test_mongo_legacy_op_query": ["tests/test_torch_thrift_mongo.py::test_mongo_legacy_op_query"],
    "tests/test_thrift_mongo.py::test_mongo_no_adaptor_reports_error": ["tests/test_torch_thrift_mongo.py::test_mongo_no_adaptor_reports_error"],
}


def _jax_files():
    return sorted(p for p in TESTS.glob("test_*.py")
                  if not p.name.startswith("test_torch_"))


def _test_functions(path):
    """{name: FunctionDef} of the test functions pytest collects from a
    file: top-level ``test*`` functions and ``Test*`` classes' methods
    (``Class::name``).  A later definition shadows an earlier one, as it
    does at import; a fixture is not a test."""
    found = {}

    def is_fixture(fn):
        return any("fixture" in ast.unparse(d) for d in fn.decorator_list)

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.startswith("test") and not is_fixture(node):
                found[node.name] = node
            else:
                found.pop(node.name, None)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and m.name.startswith("test") and not is_fixture(m):
                    found[f"{node.name}::{m.name}"] = m
    return found


def _loader_files():
    """{JAX stem: port file} of the files carried by ``torch_carry.carry``."""
    carried = {}
    for p in sorted(TESTS.glob("test_torch_*.py")):
        m = re.search(r'^carry\(globals\(\), "(\w+)"\)$', p.read_text(), re.M)
        if m:
            carried[m.group(1)] = p.name
    return carried


LOADER = _loader_files()


def _derived():
    rows = {}
    for stem, port in LOADER.items():
        for name in _test_functions(TESTS / f"{stem}.py"):
            rows[f"tests/{stem}.py::{name}"] = [f"tests/{port}::{name}"]
    return rows


LOADED = _derived()
PARITY = {**LOADED, **EXPLICIT}


def _port_cases(value):
    if isinstance(value, list):
        return value
    return list(value[2]) if len(value) > 2 else []


def _collected(port_file, _seen={}):
    """The names pytest collects from a port file: for a loader file, the
    test functions of the file it carries."""
    if port_file not in _seen:
        carried = {v: k for k, v in LOADER.items()}
        source = f"{carried[port_file]}.py" if port_file in carried else port_file
        _seen[port_file] = set(_test_functions(TESTS / source))
    return _seen[port_file]


def test_loader_rows_are_not_written_out():
    assert not set(LOADED) & set(EXPLICIT)


@pytest.mark.parametrize("path", _jax_files(), ids=lambda p: p.name)
def test_every_jax_test_function_is_mapped(path):
    """Every test function of the file is a key, and no key of the file
    names a function it does not define."""
    want = {f"tests/{path.name}::{n}" for n in _test_functions(path)}
    have = {k for k in PARITY if k.startswith(f"tests/{path.name}::")}
    assert want - have == set(), "unmapped"
    assert have - want == set(), "stale"


def test_the_map_covers_the_55_files_and_every_function():
    files = _jax_files()
    assert len(files) == 55
    assert len(PARITY) == sum(len(_test_functions(p)) for p in files)
    assert {k.split("::")[0] for k in PARITY} == {f"tests/{p.name}" for p in files}


def test_every_named_port_case_exists_and_is_collected():
    missing = []
    for key, value in PARITY.items():
        for case in _port_cases(value):
            path, _, name = case.partition("::")
            port = path.removeprefix("tests/")
            if not (port.startswith("test_torch_") and (TESTS / port).is_file()
                    and name in _collected(port)):
                missing.append((key, case))
    assert missing == []


def test_every_row_is_cases_or_a_reason_with_a_cited_line():
    bad = []
    for key, value in PARITY.items():
        if isinstance(value, list):
            if not value:
                bad.append(key)
            continue
        ok = (isinstance(value, tuple) and len(value) in (2, 3)
              and value[0] in REASONS
              and re.fullmatch(r"tests/test_\w+\.py:\d+", value[1])
              and value[1].split(":")[0] == key.split("::")[0])
        # a timing or fault-kept row names the port case that holds the rest
        if ok and value[0] in ("timing", "fault-kept"):
            ok = bool(_port_cases(value))
        if not ok:
            bad.append(key)
    assert bad == []


def _assert_lines(fn):
    """The test's def line and the first line of each of its asserts (an
    ``assert`` statement, a call of an ``assert*`` function or a
    ``pytest.raises``)."""
    lines = {fn.lineno}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assert):
            lines.add(node.lineno)
        elif isinstance(node, ast.Call):
            name = ast.unparse(node.func).rsplit(".", 1)[-1]
            if name.startswith("assert") or name == "raises":
                lines.add(node.lineno)
    return lines


def test_every_cited_line_holds_the_test_or_one_of_its_asserts():
    bad = []
    for key, value in PARITY.items():
        if isinstance(value, list):
            continue
        path, line = value[1].split(":")
        fns = _test_functions(TESTS / path.removeprefix("tests/"))
        fn = fns.get(key.split("::", 1)[1])
        if fn is None or int(line) not in _assert_lines(fn):
            bad.append((key, value[1]))
    assert bad == []


def test_later_rows_name_only_the_host_suites_over_copied_modules():
    later = [k for k, v in PARITY.items()
             if isinstance(v, tuple) and v[0] == "later"]
    assert [k for k in later if k.split("::")[0].removeprefix("tests/")
            not in LATER_ALLOWED] == []


def test_each_loader_file_is_the_three_line_carry():
    for stem, port in LOADER.items():
        assert (TESTS / port).read_text() == (
            f'from torch_carry import carry\n\ncarry(globals(), "{stem}")\n')

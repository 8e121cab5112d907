"""incubator_brpc_tpu_torch — the PyTorch/CUDA port of incubator_brpc_tpu.

The JAX package ``incubator_brpc_tpu`` is the reference; this package
keeps its layout and names, so each module's counterpart sits at the
same path.  It imports torch and never jax, and nothing of the JAX
package: the host layers it needs (runtime, metrics, transport,
protocols, client, server, chaos) are its own copies.

What is ported so far is the device-payload RPC path: ``IOBuf``
``DeviceRef`` segments over ``torch.Tensor``, the ICI fabric
(``parallel/ici.py``) and its copy kernels written by hand for Hopper
(``ops/csrc/transfer.cu``); the micro-batched parameter server
(``batching/``, ``models/parameter_server.py``); the HBM cache tier
behind the redis and memcache protocols (``cache/``); streams and the
continuous-batched decode loop (``streaming/``); disaggregated
prefill/decode serving (``serving/``); the DCN bridge between processes
(``parallel/dcn.py``), cluster channels (naming services, load
balancers), the combo channels (``client/combo.py``: parallel,
selective, partition and shard-routed fan-out), and on top of them the
clustered cache tier (``CacheChannel``) and the sharded parameter
server (``sharded_ps_channel``, ``scatter_param``), each replicated
(``replication/``) and live-resharded (``resharding/``); the
single-controller mesh and its collective lowerings
(``parallel/mesh.py``, ``parallel/collectives.py``) with the in-mesh
sharded parameter server and prefill (``batching/sharded.py``) and the
dp x tp training step; the native C++ engine (``native/``:
``Server(native_engine=True)``, ``connection_type="native"``,
``call_many`` and the submission ring) with ``tools/rpc_press.py`` and
``tools/parallel_http.py``.  ROADMAP.md lists what remains.
"""

__version__ = "0.1.0"

from incubator_brpc_tpu_torch.utils.iobuf import IOBuf  # noqa: F401
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint  # noqa: F401


def _lazy(name):
    import importlib

    return importlib.import_module(name)


def __getattr__(name):
    # lazy imports keep `import incubator_brpc_tpu_torch` light (no torch)
    mapping = {
        "Server": ("incubator_brpc_tpu_torch.server.server", "Server"),
        "ServerOptions": ("incubator_brpc_tpu_torch.server.server", "ServerOptions"),
        "Channel": ("incubator_brpc_tpu_torch.client.channel", "Channel"),
        "ChannelOptions": ("incubator_brpc_tpu_torch.client.channel", "ChannelOptions"),
        "Controller": ("incubator_brpc_tpu_torch.client.controller", "Controller"),
        "Authenticator": ("incubator_brpc_tpu_torch.client.auth", "Authenticator"),
        "AuthContext": ("incubator_brpc_tpu_torch.client.auth", "AuthContext"),
        "batching": ("incubator_brpc_tpu_torch.batching", None),
        "BatchPolicy": ("incubator_brpc_tpu_torch.batching.policy", "BatchPolicy"),
        "PsService": ("incubator_brpc_tpu_torch.models.parameter_server", "PsService"),
        "ps_stub": ("incubator_brpc_tpu_torch.models.parameter_server", "ps_stub"),
        "ParallelChannel": ("incubator_brpc_tpu_torch.client.combo", "ParallelChannel"),
        "SelectiveChannel": ("incubator_brpc_tpu_torch.client.combo", "SelectiveChannel"),
        "PartitionChannel": ("incubator_brpc_tpu_torch.client.combo", "PartitionChannel"),
    }
    if name in mapping:
        mod, attr = mapping[name]
        return _lazy(mod) if attr is None else getattr(_lazy(mod), attr)
    raise AttributeError(name)

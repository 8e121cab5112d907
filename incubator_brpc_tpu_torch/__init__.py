"""incubator_brpc_tpu_torch — the PyTorch/CUDA port of incubator_brpc_tpu.

The JAX package ``incubator_brpc_tpu`` is the reference; this package
keeps its layout and names, so each module's counterpart sits at the
same path.  It imports torch and never jax, and nothing of the JAX
package: the host layers it needs (runtime, metrics, transport,
protocols, client, server, chaos) are its own copies.

What is ported so far is the device-payload RPC path: ``IOBuf``
``DeviceRef`` segments over ``torch.Tensor``, the ICI fabric
(``parallel/ici.py``) and its copy+checksum kernels written by hand for
Hopper (``ops/csrc/transfer.cu``).  ROADMAP.md lists what remains.
"""

__version__ = "0.1.0"

from incubator_brpc_tpu_torch.utils.iobuf import IOBuf  # noqa: F401
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint  # noqa: F401


def _lazy(name):
    import importlib

    return importlib.import_module(name)


# re-exports not ported yet → their ROADMAP.md queue 1 item
_UNPORTED = {
    "Authenticator": 12,
    "AuthContext": 12,
    "ParallelChannel": 5,
    "SelectiveChannel": 12,
    "PartitionChannel": 5,
}


def __getattr__(name):
    # lazy imports keep `import incubator_brpc_tpu_torch` light (no torch)
    mapping = {
        "Server": ("incubator_brpc_tpu_torch.server.server", "Server"),
        "ServerOptions": ("incubator_brpc_tpu_torch.server.server", "ServerOptions"),
        "Channel": ("incubator_brpc_tpu_torch.client.channel", "Channel"),
        "ChannelOptions": ("incubator_brpc_tpu_torch.client.channel", "ChannelOptions"),
        "Controller": ("incubator_brpc_tpu_torch.client.controller", "Controller"),
    }
    if name in mapping:
        mod, attr = mapping[name]
        return getattr(_lazy(mod), attr)
    if name in _UNPORTED:
        from incubator_brpc_tpu_torch.unported import unported

        unported(name, _UNPORTED[name])
    raise AttributeError(name)

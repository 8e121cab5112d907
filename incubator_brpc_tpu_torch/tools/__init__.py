"""Operator tools (reference tools/): rpc_press load generator,
rpc_replay for rpc_dump samples, rpc_view builtin-page proxy,
parallel_http mass fetcher. Each is runnable:
``python -m incubator_brpc_tpu_torch.tools.rpc_press --help``."""

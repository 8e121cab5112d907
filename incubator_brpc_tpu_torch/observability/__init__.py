"""Observability: rpcz tracing spans, rpc_dump sampling (reference
span.{h,cpp}, rpc_dump.{h,cpp})."""

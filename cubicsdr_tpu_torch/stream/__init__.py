"""Block-streaming substrate: the StreamOp contract."""

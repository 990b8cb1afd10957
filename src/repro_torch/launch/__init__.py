"""Entry points of the port: ``serve`` (batched prefill + greedy decode)."""

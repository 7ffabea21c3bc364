"""Workloads the monitor watches, in PyTorch: the Llama-style model
(``model``), the paged KV pool (``paged_kv``) and the continuous-batching
serving engine with its ``/metrics`` endpoint (``serving``)."""

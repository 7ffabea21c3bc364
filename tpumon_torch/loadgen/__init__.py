"""Workloads the monitor watches, in PyTorch: the Llama-style model
(``model``), the paged KV pool (``paged_kv``), the continuous-batching
serving engine with its dense cache and ``/metrics`` endpoint
(``serving``), multi-token decode (``speculative``), the burns (``burn``),
the trainer (``train``, with the induction trainer and its Adam step) with
its checkpoints (``checkpoint``) and the online-softmax block update of its
chunked schedule (``ring_attention``), the Mixture-of-Experts FFN
(``moe``), and the workload self-report (``report``)."""

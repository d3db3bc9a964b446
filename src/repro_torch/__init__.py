"""PyTorch/CUDA port of the DNNVM reproduction.

Each subpackage mirrors one of ``repro``'s: ``core`` (graph, planning,
quantization, int8 semantics, executor, validation), ``cnn`` (the model
builders), ``hw`` (device models), ``kernels`` (hand-written CUDA kernels with
their plain PyTorch versions), ``obs`` (tracer and metrics) and ``runtime``
(Session, batcher, Server).  The package imports ``torch`` and never ``jax``
or ``repro``; entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

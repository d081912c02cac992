"""commet_tpu_torch: COMMET's all-vs-all read-set comparison in PyTorch, with
its device kernels written by hand in CUDA for an NVIDIA H100.

The port of commet_tpu (the JAX package, kept as the reference). This slice
runs the sorted-join stream path: keygen (``core.keys``), the greedy hit
count (``core.greedy``), the sorted index, query join and verdict sandwich
with its exact fallback (``core.stream``, join kernel in
``core/csrc/join.cu``), the engine (``engine.engine``) and the
``index_and_search`` and ``commet`` CLIs (``cli``). It reuses commet_tpu's
JAX-free host modules (read parsing, bit vectors, manifests, the native IO
library, the read filter and the plots) and never imports JAX.
"""

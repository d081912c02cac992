"""commet_tpu_torch: COMMET's all-vs-all read-set comparison in PyTorch, with
its device kernels written by hand in CUDA for an NVIDIA H100.

The port of commet_tpu (the JAX package, kept as the reference). It runs
the sorted-join stream path: keygen (``core.keys``), the greedy hit count
(``core.greedy``), the sorted index, query join and verdict sandwich with
its exact fallback (``core.stream``, join kernels in ``core/csrc/join.cu``),
and the dense-plane path (``core.planes``, build and probe kernels in
``core/csrc/planes.cu``), under the engine (``engine.engine``), the job
DAG of ``commet --jobs`` (``engine.scheduler``) and the CLIs (``cli``:
``commet``, ``index_and_search``, ``compare_reads``, ``commet_analysis``,
``filter_reads``, ``bvop``, ``extract_reads``, ``generate_random_bv``). Its
host layer is its own: read sets (``io.reads``), bit vectors (``io.bv``),
manifests (``io.fof``), the native IO library (``native``, built with g++
at first use), the read filter (``core.filter``) and the plots (``viz``).
It imports neither JAX nor anything of commet_tpu.
"""

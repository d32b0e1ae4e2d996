"""PyTorch/CUDA port of ``genomics_rs_tpu``.

The JAX package beside this one is the reference; every module here
keeps its counterpart's name and contract so a reader can find it.
Device code runs as hand-written CUDA kernels for Hopper (``csrc/``),
built at first use; a CPU tensor takes each kernel's plain PyTorch
version instead. Nothing here imports JAX.

Ported so far: the ``align`` path (``models/aligner``,
``models/longalign``) with its two kernels, the row-block Gotoh fill
(``ops/gotoh_rowblock``) and the traceback walker
(``ops/traceback_walker``); and the ``align-matrix`` path
(``parallel/allpairs``, ``parallel/batch``, ``models/aligner.align_batch``)
with two more, the batched fill (``ops/gotoh_stream``) and the batched
walker (``ops/traceback_walker.walk_many``); the read workloads
(``models/reads``, ``models/mapper``, ``models/caller``); banded
alignment (``models/banded``); protein alignment under a substitution
matrix (``ops/gotoh_matrix``, ``ops/gotoh_matrix_stream``),
center-star MSA (``models/msa``), and the suffix structures: the suffix
tree on the host (``suffixtree``), the suffix array and BWT as torch ops
(``ops/bwt_device``), the FM-index with its batched device search
(``suffixtree/fmindex``) and the all-pairs LCS comparison
(``comparison``).
"""

__version__ = "0.1.0"

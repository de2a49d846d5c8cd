"""coverm-tpu on PyTorch and CUDA: the metagenomic coverage engine for
an NVIDIA Hopper card.

A port of the JAX package `coverm_tpu` (kept beside it as the reference):
the same CLI, the same integer statistics and the same TSV bytes.
Architecture:

  native C++ BAM ingest (ctypes)  ->  contig-closed block arrays
  ->  torch event sweep on the card (sort, hand-written CUDA sweep-scan
      kernel, int64 cumsums and per-contig boundary differences)
  ->  exact estimator suite  ->  takers  ->  printers (TSV contracts)

Entry points run on `cuda`; `COVERM_TPU_TORCH_DEVICE=cpu` asks for the
CPU (see device.py).
"""

__version__ = "0.1.0"

CONCATENATED_FASTA_FILE_SEPARATOR = "~"

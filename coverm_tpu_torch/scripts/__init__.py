"""The port's measuring and checking tools, counterparts of the JAX
package's scripts/ of the same names:

    python -m coverm_tpu_torch.scripts.profile_ingest [bam]
    python -m coverm_tpu_torch.scripts.validate sorted.bam [more.bam ...]
    python -m coverm_tpu_torch.scripts.scaling_bench [--nproc 2]
    python -m coverm_tpu_torch.scripts.dp_ab_bench [--blocks 400000]

Each runs on the card unless the caller asks for the CPU (`--device cpu`
or COVERM_TPU_TORCH_DEVICE=cpu); without a card and without that request
it raises, as the CLI does. Each ends with one JSON line carrying the
card's name and power limit and the host's CPU count (common.py).
"""

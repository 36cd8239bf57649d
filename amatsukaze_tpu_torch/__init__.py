"""PyTorch/CUDA port of the per-file CM analysis and filter core of
amatsukaze_tpu.

The CM analysis pass (scene metrics and logo scoring from one upload per
batch, silence, the CM decision and the chapters' elements), logo erase,
KFM telecine analysis and output synthesis (weave / pulldown repair / bob,
or yadif) run on an NVIDIA H100, with the three Pallas TPU kernels of the
JAX package replaced by two hand-written CUDA kernels (ops/csrc). Module
names mirror amatsukaze_tpu; the JAX package stays the reference. Entry
points take ``device=None`` (the CUDA card) or ``device="cpu"``, where
every kernel runs its plain PyTorch version.
"""

"""The card's published peaks: NVIDIA H100 SXM5 data sheet, dense rates
without sparsity, at the full 700 W power limit.  A frozen copy of the
program's ``launch/roofline.py`` constants, kept here so that a change to
the program cannot move the yardstick."""

PEAK_BF16_FLOPS = 989e12   # FLOP/s, bf16 / fp16 tensor cores, dense
PEAK_F32_FLOPS = 67e12     # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3

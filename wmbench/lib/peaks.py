"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit).  A share of a roofline is stated against these, with the
card's power limit beside it."""

F32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

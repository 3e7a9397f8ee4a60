"""wmbench: the benchmark of audiowmark_tpu_torch on CUDA cards.

    python3 -m wmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints one JSON line.  Everything
that belongs to one configuration, traffic mix, entry point or per-layer
metric is a file of its own, found by its name:

    wmbench/configs/<config>.json       a deployment's settings
    wmbench/traffic/<cell>.json         a cell's traffic mix and limits
    wmbench/entries/<entry>.py          the driver of one entry point
    wmbench/layer_metrics/<metric>.py   the reader of one per-layer metric

`wmbench/reference/` is the plain reference that decides `correct`; it
imports nothing of the program.
"""

"""The harness's own arithmetic: traffic, statistics, traces, counts."""

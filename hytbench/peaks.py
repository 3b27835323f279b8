"""Published peaks of the card the benchmark runs on (NVIDIA's H100 SXM
data sheet, at its 700 W power limit): the yardstick of every roofline
share.  A card set below 700 W reaches less; the run's record names the
card, and ``PERF.md`` gives its power limit beside each share."""

HBM_BYTES_PER_S = 3.35e12   # 80 GB of HBM3

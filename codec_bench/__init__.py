"""The benchmark of vrvq_tpu_torch: one command runs one cell once.

``python3 -m codec_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; see ``README.md``.
"""

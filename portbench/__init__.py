"""The benchmark of the PyTorch and CUDA port (`vtgaussian_slam_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.
"""

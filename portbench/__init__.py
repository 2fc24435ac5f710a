"""The benchmark of the PyTorch and CUDA port
(`weatherforecast_stgcn_maml_tpu_torch`): run one cell with
`python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`.
See README.md."""

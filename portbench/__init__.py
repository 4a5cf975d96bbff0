"""The benchmark of mtf_tpu_torch on the H100 (`python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`)."""

"""Command-line applications of the port (counterparts of `mtf_tpu/apps/`):
`run_mtf` (the evaluation harness) and `eval_suite` (the milestone
configurations on synthetic GT)."""

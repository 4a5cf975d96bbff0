"""Command-line applications of the port (counterparts of `mtf_tpu/apps/`):
`run_mtf` (the evaluation harness), `eval_suite` (the milestone
configurations on synthetic GT), `diagnose`, `tracker_node`,
`parity_cv2`, `register_seq`, `create_mosaic`, `generate_synthetic_seq`,
`extract_patch`, `show_ground_truth`, `record_seq`, `track_markers` and
`track_uav_trajectory`. Each runs on the card unless `--device` names
another device."""

from mtf_tpu_torch.parallel.fleet import TrackerFleet  # noqa: F401

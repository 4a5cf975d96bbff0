"""The port's demos (counterparts of the root `examples/`): run each with
`python -m mtf_tpu_torch.examples.<name> [--device cpu]`; they write
their output under the current directory."""

"""Command-line runners of the port: `python -m
ldso_tpu_torch.examples.run_dso_{tum_mono,kitti,euroc} files=... calib=...`."""

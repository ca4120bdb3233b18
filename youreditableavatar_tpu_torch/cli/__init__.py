"""Command-line entry points: the four-stage pipeline (`pipeline`, the
run.sh role) and the three stage CLIs, each run as
`python -m youreditableavatar_tpu_torch.cli.<train_spatial |
train_init_texture | train_edit_texture>`."""

"""Command-line entry points of the port, run as
`python -m brainfm_tpu_torch.scripts.<name>`."""

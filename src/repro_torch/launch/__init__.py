# Command-line launchers of the port (run as ``python -m repro_torch.launch.<name>``).

"""The paper's experiments on the port, one command each
(``python -m repro_torch.experiments.<name>``)."""

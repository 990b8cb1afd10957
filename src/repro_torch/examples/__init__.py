"""The paper's example programs on the port, each run as
``python -m repro_torch.examples.<name>`` (``--device cpu`` off the card)."""

"""Guidance backends: the protocols the stages call, weight-free stubs, and
the diffusion networks (SD1.5; SDXL + ControlNet-Union) behind them."""

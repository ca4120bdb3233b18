"""Guidance backends: the protocols the stages call, weight-free stubs, the
diffusion networks (SD1.5; SDXL + ControlNet-Union) and the segmentation
networks (SAM, GroundingDINO with its WordPiece tokenizer) behind them."""

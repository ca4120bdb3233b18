"""Camera sampling datamodules for the spatial stage."""

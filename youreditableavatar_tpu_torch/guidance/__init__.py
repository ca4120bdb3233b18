"""Guidance backends: the protocols the stages call and weight-free stubs."""

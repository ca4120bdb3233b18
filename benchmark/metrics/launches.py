"""Kernel launches per step or call in the profiled window (memcpys and
memsets left out): the host glue. Reads `launches.<anything>`."""


def read(run, kernels):
    t = run.trace
    if t is None or not t.kernels or t.iters <= 0:
        return None
    return len(t.kernels) / t.iters

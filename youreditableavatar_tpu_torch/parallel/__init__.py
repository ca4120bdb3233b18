"""Multi-process parallelism: views over `data`, rasterizer tiles over `tile`.

Counterpart of `youreditableavatar_tpu/parallel` on `torch.distributed`:

  * `data` — camera views (data parallelism; the reference's DDP axis),
  * `tile` — bands of the rasterizer's screen-tile rows, all-gathered to
    assemble each image, with one all-reduce to combine the gradients.

Parameters start replicated by construction (every rank builds them from
the same inputs), with no broadcast; `utils.misc.assert_replicated` is the
invariant check.
"""

from youreditableavatar_tpu_torch.parallel.mesh import (
    distributed_init,
    make_mesh,
)
from youreditableavatar_tpu_torch.parallel.train_step import (
    make_sharded_render_train_step,
)

__all__ = [
    "distributed_init",
    "make_mesh",
    "make_sharded_render_train_step",
]

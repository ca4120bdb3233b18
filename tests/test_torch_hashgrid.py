"""PyTorch port vs the JAX package: the hash-grid encoding and K4.

The port's encoding is a `torch.autograd.Function` whose table gradient
goes through `hash_scatter_add` (K4; its plain version, `index_add_`, on
the CPU). It is held against the JAX encoding's XLA autodiff and its
custom VJP with the Pallas scatter run interpreted, at the sizes of
`tests/test_geometry.py`. Corner ids and level masks must agree bit for
bit; features to 1e-6; gradients at the JAX suite's own Pallas-vs-XLA
tolerances (table rtol 1e-5, points rtol 1e-4, atol 1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    cuda_device,  # noqa: F401  (fixture)
    single_threaded_torch,  # noqa: F401  (fixture)
)

from youreditableavatar_tpu.ops import hashgrid as jhg
from youreditableavatar_tpu_torch.ops import hashgrid as thg
from youreditableavatar_tpu_torch.ops import hashgrid_cuda


def _cfgs(**kw):
    return (jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw))


# Levels 0–1 dense, 2–5 hashed at T = 2^13 (res 4, 8, 16, 32, 64, 128).
MIXED = dict(n_levels=6, log2_hashmap_size=13, base_resolution=4,
             per_level_scale=2.0, progressive=True, start_level=3,
             update_steps=100)


def _points(n, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _table(cfg, seed):
    return np.asarray(jhg.init_hashgrid_params(jax.random.PRNGKey(seed), cfg))


class TestCorners:
    def test_corner_ids_bit_equal(self):
        jc, tc = _cfgs(**MIXED)
        x = _points(512, 0)
        kinds = []
        for res in jc.level_resolutions():
            kinds.append((res + 1) ** 3 <= jc.table_size)
            ji, *jw = jhg._level_corners(jnp.asarray(x), res, jc.table_size)
            ti, *tw = thg._level_corners(torch.tensor(x), res, tc.table_size)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji),
                                          err_msg=f"res {res}")
            for a, b in zip(tw, jw):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert any(kinds) and not all(kinds)  # dense and hashed levels

    def test_hash_of_large_coords(self):
        """The 32-bit wrap of the hash products at the production finest
        level (res 2,048) and beyond."""
        coords = np.random.default_rng(1).integers(0, 40_000, (4096, 3))
        a = np.asarray(jhg._hash_corner(jnp.asarray(coords, jnp.int32),
                                        40_000, 1 << 19))
        b = thg._hash_corner(torch.tensor(coords), 40_000, 1 << 19)
        np.testing.assert_array_equal(b.numpy(), a)

    @pytest.mark.parametrize("step", [0, 99, 150, 250, 10_000])
    def test_progressive_mask(self, step):
        jc, tc = _cfgs(n_levels=8, progressive=True, start_level=2,
                       start_step=0, update_steps=100)
        np.testing.assert_array_equal(
            thg.progressive_level_mask(tc, step).numpy(),
            np.asarray(jhg.progressive_level_mask(jc, step)))

    def test_mask_without_progression(self):
        jc, tc = _cfgs(n_levels=4, progressive=False)
        np.testing.assert_array_equal(
            thg.progressive_level_mask(tc, 0).numpy(),
            np.asarray(jhg.progressive_level_mask(jc, 0)))


class TestEncode:
    @pytest.mark.parametrize("n_active,masked", [(None, False), (None, True),
                                                 (4, True)])
    def test_features(self, n_active, masked):
        jc, tc = _cfgs(**MIXED)
        table = _table(jc, 0)
        x = _points(700, 2)
        jm = jhg.progressive_level_mask(jc, 150) if masked else None
        tm = thg.progressive_level_mask(tc, 150) if masked else None
        a = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(x),
                                           jc, jm, backend="xla",
                                           n_active=n_active))
        b = thg.hashgrid_encode(torch.tensor(table), torch.tensor(x), tc, tm,
                                n_active=n_active)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_gradients(self, backend):
        """Table and point gradients, under a partial progressive mask, at
        the size of test_geometry's Pallas grad-parity test."""
        kw = dict(n_levels=3, base_resolution=4, log2_hashmap_size=8,
                  progressive=True, start_level=2, update_steps=100)
        jc, tc = _cfgs(**kw)
        table = _table(jc, 0)
        x = _points(64, 3, 0.05, 0.95)

        def jloss(p, xx):
            return jnp.sum(jnp.sin(jhg.hashgrid_encode(
                p, xx, jc, jhg.progressive_level_mask(jc, 50),
                backend=backend)) ** 2)

        jl, (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jnp.asarray(table), jnp.asarray(x))
        tp = torch.tensor(table, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        tl = torch.sum(torch.sin(thg.hashgrid_encode(
            tp, tx, tc, thg.progressive_level_mask(tc, 50))) ** 2)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-5,
                                   atol=1e-8, err_msg="table grad")
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                                   atol=1e-8, err_msg="point grad")
        assert float(tp.grad[2].abs().max()) == 0.0  # masked level

    @pytest.mark.parametrize("features", [1, 4])
    def test_other_widths_use_index_add(self, features):
        """Widths K4 does not serve: the table gradient is `index_add_`,
        against JAX's XLA autodiff; no K4 launch is counted."""
        from youreditableavatar_tpu_torch import _kernels

        jc, tc = _cfgs(n_levels=3, base_resolution=4, log2_hashmap_size=8,
                       n_features_per_level=features)
        table = _table(jc, 1)
        x = _points(96, 4, 0.05, 0.95)
        w = np.random.default_rng(5).normal(
            size=(96, jc.out_dim)).astype(np.float32)

        gp, gx = jax.grad(lambda p, xx: jnp.sum(
            jhg.hashgrid_encode(p, xx, jc, backend="xla") * w),
            argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
        tp = torch.tensor(table, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        before = _kernels.LAUNCHES["hash_scatter"]
        torch.sum(thg.hashgrid_encode(tp, tx, tc) * torch.tensor(w)).backward()
        assert _kernels.LAUNCHES["hash_scatter"] == before
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                                   atol=1e-7)

    def test_n_active_skip_exact(self):
        """n_active must equal the masked full computation bit for bit,
        values and table gradients, with exactly-zero masked levels."""
        _, tc = _cfgs(n_levels=6, log2_hashmap_size=8, base_resolution=4,
                      progressive=True, start_level=3, update_steps=100)
        table = torch.tensor(_table(jhg.HashGridConfig(
            n_levels=6, log2_hashmap_size=8), 0))
        x = torch.tensor(_points(128, 6, 0.05, 0.95))
        lm = thg.progressive_level_mask(tc, 150)  # 4 of 6 active

        def run(n_active):
            p = table.clone().requires_grad_()
            out = thg.hashgrid_encode(p, x, tc, lm, n_active=n_active)
            torch.sum(out ** 2).backward()
            return out.detach(), p.grad

        (oa, ga), (ob, gb) = run(None), run(4)
        assert torch.equal(oa, ob) and torch.equal(ga, gb)
        assert float(gb[4:].abs().max()) == 0.0

    def test_init_range(self):
        _, tc = _cfgs(n_levels=2, log2_hashmap_size=10)
        t = thg.init_hashgrid_params(torch.Generator().manual_seed(0), tc)
        assert t.shape == (2, 1024, 2) and float(t.abs().max()) <= 1e-4


class TestScatter:
    def test_plain_matches_pallas_interpret(self):
        """`hash_scatter_add_plain` against the JAX kernel run interpreted,
        with padding sentinels (idx == T) and a row count that is not a
        multiple of the kernel's chunk."""
        from youreditableavatar_tpu.ops.hashgrid_pallas import hash_scatter_add

        rng = np.random.default_rng(7)
        L, R, T = 3, 700, 256
        idx = rng.integers(0, T + 1, (L, R)).astype(np.int32)  # T = sentinel
        assert (idx == T).any()
        v0 = rng.normal(size=(L, R)).astype(np.float32)
        v1 = rng.normal(size=(L, R)).astype(np.float32)
        ref = np.asarray(hash_scatter_add(jnp.asarray(idx), jnp.asarray(v0),
                                          jnp.asarray(v1), T))
        out = hashgrid_cuda.hash_scatter_add_plain(
            torch.tensor(idx), torch.tensor(v0), torch.tensor(v1), T)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
        # The CPU tensor path of the wrapper is the plain version.
        same = hashgrid_cuda.hash_scatter_add(
            torch.tensor(idx), torch.tensor(v0), torch.tensor(v1), T)
        assert torch.equal(same, out)

    def test_contract_checks(self):
        idx = torch.zeros((2, 8), dtype=torch.int32)
        v = torch.zeros((2, 8))
        with pytest.raises(ValueError):
            hashgrid_cuda.hash_scatter_add(idx, v, v, 100)  # not % 64
        with pytest.raises(ValueError):
            hashgrid_cuda.hash_scatter_add(idx, v[:, :4], v, 128)


@pytest.mark.cuda
def test_hash_scatter_kernel_matches_plain_on_card(cuda_device):
    """K4 against its plain version on the card: max |card − plain| ≤
    1e-5 · max |plain| per level (float atomics reorder the sums)."""
    rng = np.random.default_rng(3)
    L, R, T = 4, 1 << 16, 1 << 13
    idx = rng.integers(0, T + 1, (L, R)).astype(np.int32)
    idx[0] = rng.integers(0, 64, R)  # a dense level: many adds per row
    v0 = rng.normal(size=(L, R)).astype(np.float32)
    v1 = rng.normal(size=(L, R)).astype(np.float32)
    args = [torch.tensor(a, device=cuda_device) for a in (idx, v0, v1)]
    out = hashgrid_cuda.hash_scatter_add(*args, T).cpu()
    ref = hashgrid_cuda.hash_scatter_add_plain(
        *(torch.tensor(a) for a in (idx, v0, v1)), T)
    for lv in range(L):
        tol = 1e-5 * float(ref[lv].abs().max())
        assert float((out[lv] - ref[lv]).abs().max()) <= tol

"""The port's in-kernel random generator (`wheeledlab_torch/ops/kernel_rng.py`)
on the CPU: Philox4x32-10 against its published known answers and an
arbitrary-precision rendition, the bit extraction and Box-Muller against the
JAX reference's expressions (`wheeledlab_tpu/tasks/drift/fused.py:426-432`)
on the same words, independence of the batch size, the moment bounds of
`scripts/check_kernel_rng.py`, and the check script itself.

The kernels that draw these rows (`csrc/rng_blocks.cu`,
`csrc/fused_drift_krng.cu`) only run on a GPU; `chip_smoke.py` holds them
against `philox_blocks` there, word for word."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_torch.ops import build
from wheeledlab_torch.ops import kernel_rng as kr
from wheeledlab_torch.scripts import check_kernel_rng

torch.set_num_threads(1)

# Random123's known-answer vectors for philox4x32-10 (kat_vectors)
KNOWN_ANSWERS = {
    "zeros": ((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
           (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


def seed_tensor(seed):
    return torch.tensor([seed], dtype=torch.int32)


def philox_python(counter, key):
    """Philox4x32-10 on Python ints (no overflow anywhere)."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = kr.M0 * c[0], kr.M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & kr.MASK,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & kr.MASK]
        k = [(k[0] + kr.W0) & kr.MASK, (k[1] + kr.W1) & kr.MASK]
    return tuple(c)


class TestPhilox:
    @pytest.mark.parametrize("name", sorted(KNOWN_ANSWERS))
    def test_known_answers(self, name):
        counter, key, want = KNOWN_ANSWERS[name]
        t = lambda v: [torch.tensor(x, dtype=torch.int64) for x in v]
        got = kr.philox4x32_10(t(counter), t(key))
        assert tuple(int(w) for w in got) == want
        assert philox_python(counter, key) == want

    def test_tensor_version_matches_python_ints(self):
        """int64 products wrap and `>>` is arithmetic: the masked tensor
        version still gives the exact words, for any counter and key."""
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 2**32, (6, 64), dtype=np.uint64)
        vals[:, 0] = 0xFFFFFFFF                       # the widest products
        cols = [torch.tensor(v.astype(np.int64)) for v in vals]
        got = torch.stack(kr.philox4x32_10(cols[:4], cols[4:])).numpy()
        for i in range(64):
            want = philox_python([int(v[i]) for v in vals[:4]],
                                 [int(v[i]) for v in vals[4:]])
            assert tuple(int(w) for w in got[:, i]) == want

    def test_words_are_draws_of_seed_env_and_index(self):
        """Draw j of env b is word j % 4 of Philox(counter (b, j // 4, 0, 0),
        key (seed, KEY1)); a negative int32 seed is its uint32 pattern."""
        for seed in (1234, -7):
            words = kr.philox_words(seed_tensor(seed), 5, 40).numpy()
            for b, j in ((0, 0), (3, 11), (4, 12), (2, 27), (4, 39)):
                want = philox_python((b, j // 4, 0, 0),
                                     (seed & kr.MASK, kr.KEY1))[j % 4]
                assert int(words[j, b]) == want


class TestBlocks:
    def test_extraction_and_box_muller_match_the_reference(self):
        """The reference's expressions (jnp, on the CPU) applied to the
        port's words: uniforms exactly; normals to 1e-6 (the packages' float32
        log and cos differ in the last ulp)."""
        seed, b = seed_tensor(99), 512
        words = kr.philox_words(seed, b, 40).numpy().astype(np.uint32)
        bits = jnp.asarray(words.view(np.int32))
        u = ((bits >> 7) & jnp.int32(0x00FFFFFF)).astype(jnp.float32) * (
            1.0 / (1 << 24))
        u1 = jnp.maximum(u[12:26], 1e-7)
        nrm = jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * jnp.pi * u[26:])
        uniforms, normals = kr.philox_blocks(seed, b)
        assert uniforms.shape == (12, b) and normals.shape == (14, b)
        assert uniforms.dtype == normals.dtype == torch.float32
        np.testing.assert_array_equal(uniforms.numpy(), np.asarray(u[:12]))
        np.testing.assert_allclose(normals.numpy(), np.asarray(nrm),
                                   atol=1e-6, rtol=0)

    def test_noise_off_draws_only_the_uniforms(self):
        seed = seed_tensor(5)
        u_on, _ = kr.philox_blocks(seed, 64, noise=True)
        u_off, n_off = kr.philox_blocks(seed, 64, noise=False)
        assert torch.equal(u_on, u_off)
        assert n_off.shape == (14, 64) and not n_off.any()

    def test_draws_do_not_depend_on_the_batch_size(self):
        seed = seed_tensor(1234)
        u_big, n_big = kr.philox_blocks(seed, 4096)
        u_small, n_small = kr.philox_blocks(seed, 16)
        assert torch.equal(u_small, u_big[:, :16])
        assert torch.equal(n_small, n_big[:, :16])

    def test_moments_within_the_check_scripts_bounds(self):
        """The bounds of scripts/check_kernel_rng.py:74-83 at B = 4096."""
        u, n = (x.numpy() for x in kr.philox_blocks(seed_tensor(1234), 4096))
        assert 0.49 <= u.mean() <= 0.51 and 0.283 <= u.std() <= 0.295
        assert 0.0 <= u.min() <= 0.01 and 0.99 <= u.max() < 1.0
        assert -0.03 <= n.mean() <= 0.03 and 0.98 <= n.std() <= 1.02
        kurt = ((n - n.mean()) ** 4).mean() / n.std() ** 4
        assert 2.8 <= kurt <= 3.2
        lag1 = np.corrcoef(u.ravel()[:-1], u.ravel()[1:])[0, 1]
        assert abs(lag1) <= 0.03
        u2, _ = kr.philox_blocks(seed_tensor(99), 4096)
        assert not np.array_equal(u, u2.numpy())

    def test_cpu_wrapper_is_the_plain_version_and_launches_nothing(self):
        seed = seed_tensor(42)
        before = kr.LAUNCHES
        got = kr.rng_blocks(seed, 100)
        assert kr.LAUNCHES == before
        for g, w in zip(got, kr.philox_blocks(seed, 100)):
            assert torch.equal(g, w)

    def test_rejects_bad_seeds(self):
        for bad in (torch.tensor([1]), torch.tensor([1, 2], dtype=torch.int32),
                    torch.tensor(1, dtype=torch.int32)):
            with pytest.raises(TypeError):
                kr.rng_blocks(bad, 8)
        with pytest.raises(ValueError, match="meta"):
            kr.rng_blocks(seed_tensor(1).to("meta"), 8)


class TestCheckScript:
    def test_passes_on_the_cpu(self, capsys):
        assert check_kernel_rng.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "kernel RNG check passed" in out and "FAIL" not in out

    def test_fails_on_a_broken_generator(self, monkeypatch, capsys):
        """A generator whose envs all draw the same stream is caught."""
        def same_stream(seed, b):
            u, n = kr.philox_blocks(seed, 1)
            return u.expand(12, b).contiguous(), n.expand(14, b).contiguous()

        monkeypatch.setattr(kr, "rng_blocks", same_stream)
        assert check_kernel_rng.main(["--device", "cpu"]) == 1
        assert "KERNEL RNG CHECK FAILED" in capsys.readouterr().out

    def test_default_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA"):
            check_kernel_rng.main([])


# (source, launcher, pointer arguments, int arguments before the stream)
LAUNCHERS = {
    "fused_drift_krng": ("fused_drift_krng_launch", 10 + 7, 1),
    "multi_step": ("multi_step_launch", 11 + 5, 2),
    "rng_blocks": ("rng_blocks_launch", 3, 1),
}


class TestKernelSources:
    """The C interfaces of the new kernels, checked against the CUDA sources
    here (nothing compiles CUDA on the CPU)."""

    @pytest.mark.parametrize("name", sorted(LAUNCHERS))
    def test_launcher_takes_the_wrappers_arguments(self, name):
        launcher, pointers, ints = LAUNCHERS[name]
        assert name in build.SOURCES
        src = open(os.path.join(build.CSRC, f"{name}.cu")).read()
        sig = re.search(rf'extern "C" int {launcher}\((.*?)\)', src,
                        re.S).group(1)
        params = [p.strip() for p in sig.split(",")]
        if name != "rng_blocks":
            assert params.pop(0).startswith("wl::FusedDriftConsts")
        assert params[-1] == "void* stream"
        assert len([p for p in params[:-1] if "*" in p]) == pointers
        assert [p.split()[0] for p in params[-1 - ints:-1]] == ["int"] * ints

    def test_kernel_constants_mirror_the_plain_version(self):
        src = open(os.path.join(build.CSRC, "philox.cuh")).read()
        for name, value in (("kPhiloxM0", kr.M0), ("kPhiloxM1", kr.M1),
                            ("kPhiloxW0", kr.W0), ("kPhiloxW1", kr.W1),
                            ("kPhiloxKey1", kr.KEY1)):
            found = re.search(rf"{name} = (0x[0-9A-Fa-f]+)u", src).group(1)
            assert int(found, 16) == value, name
        assert "6.2831855f" in src and "1e-7f" in src
        # precise libm only: the plain version uses torch.log / torch.cos
        assert "__logf" not in src and "__cosf" not in src
        assert "use_fast_math" not in " ".join(build.NVCC_FLAGS)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))

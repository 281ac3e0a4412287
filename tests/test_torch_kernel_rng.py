"""The port's in-kernel random generator (`wheeledlab_torch/ops/kernel_rng.py`)
on the CPU: Philox4x32-10 against its published known answers and an
arbitrary-precision rendition, the bit extraction and Box-Muller against the
JAX reference's expressions (`wheeledlab_tpu/tasks/drift/fused.py:426-432`)
on the same words, independence of the batch size, the moment bounds of
`scripts/check_kernel_rng.py`, the check script itself, and a numpy model
of how the 4 lanes of an env's group share the draws in the kernels
(`csrc/philox.cuh::PhiloxGroupRows`).

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


def header_constants(name):
    """The namespace-level `constexpr int` constants of a CUDA header of the
    port, each expression evaluated with the ones before it."""
    with open(os.path.join(build.CSRC, name)) as f:
        src = f.read()
    env = {}
    for n, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                              re.M):
        env[n] = eval(expr, {}, dict(env))  # noqa: S307  integer expressions
    return env


class GroupModel:
    """numpy model of `philox.cuh::PhiloxGroupRows` for `b` envs, with the
    lane-ownership constants parsed from the CUDA headers: in the round
    whose first draw is F, lane L of an env's group computes Philox call
    (F >> 2) + L; `philox_round` renames each lane's words by F & 3,
    transposes them across the group with two butterfly stages of xor
    shuffles (lanes w ^ 2, then w ^ 1) and shifts a lane whose word index
    passes 3 one position on. Arrays are (lanes, ..., B); a value may be the
    pair (computing call, word) in place of the word itself (`provenance`),
    which tracks where each draw a lane uses was computed."""

    def __init__(self, seed, b, provenance=False):
        c = header_constants("philox.cuh")
        self.lanes = header_constants("substep.cuh")["kLanesPerEnv"]
        self.uniform_draw = c["kUniformDraw"]
        self.u1_draw, self.u2_draw = c["kU1Draw"], c["kU2Draw"]
        self.slots = c["kGroupSlots"]
        self.uniform_rows = c["kRngUniformRows"]
        self.normal_rows = c["kRngNormalRows"]
        self.b, self.provenance = b, provenance
        self.calls = []                      # (round's first draw, lane, call)
        last = (self.u2_draw >> 2) + self.lanes
        if provenance:
            q, w = np.meshgrid(np.arange(last), np.arange(4), indexing="ij")
            self.words = np.broadcast_to((100 * q + w)[..., None],
                                         (last, 4, b))
        else:
            self.words = kr.philox_words(seed, b, 4 * last).numpy().astype(
                np.int64).reshape(last, 4, b)

    def call(self, first):
        """(lanes, 4, B): each lane's words of its call in this round."""
        q = (first >> 2) + np.arange(self.lanes)
        self.calls += [(first, lane, int(c)) for lane, c in enumerate(q)]
        return self.words[q].copy()

    def transpose(self, v):
        lanes = np.arange(self.lanes)
        v = v.copy()
        m = self.lanes // 2
        while m >= 1:
            hi = ((lanes & m) != 0)[:, None]
            for j in range(4):
                if j & m:
                    continue
                send = np.where(hi, v[:, j], v[:, j | m])
                got = send[lanes ^ m]                  # __shfl_xor_sync
                v[:, j], v[:, j | m] = (np.where(hi, got, v[:, j]),
                                        np.where(hi, v[:, j | m], got))
            m //= 2
        return v

    def round(self, first):
        """`philox_round<first>`: (lanes, slots, B), slot k of lane w the
        word of draw first + 4 k + w (-1 where none)."""
        shift = first & 3
        v = self.call(first)
        t = self.transpose(v[:, [(j + shift) & 3 for j in range(4)]])
        carry = (np.arange(self.lanes) + shift > 3)[:, None]
        col = np.full((self.lanes, self.slots, self.b), -1, np.int64)
        for k in range(self.slots):
            nxt = t[:, k + 1] if k + 1 < 4 else np.full_like(t[:, 0], -1)
            col[:, k] = np.where(carry, nxt, t[:, k])
        return col

    def uniform(self, u, row):
        """`uniform(row)` on every lane: lane (j >> 2) - (F >> 2) sends word
        j & 3 of its uniform-round call `u`; (lanes, B)."""
        j = self.uniform_draw + row
        owner = (j >> 2) - (self.uniform_draw >> 2)
        return np.broadcast_to(u[owner, j & 3], (self.lanes, self.b))


def bits(words):
    return kr.bits_to_uniform(torch.from_numpy(np.array(words, np.int64)))


class TestGroupSchedule:
    """The group generator's schedule, modelled in numpy from the constants
    of `csrc/philox.cuh` and `csrc/substep.cuh`, reproduces `philox_blocks`
    for every (env, row): the rows K4 reads (uniform rows on every lane, the
    normal of row i on lane i & 3) and the blocks K5b stores (lane w rows
    4 k + w), bit for bit."""

    def test_the_rounds_are_the_reference_draw_blocks(self):
        c = header_constants("philox.cuh")
        assert (c["kUniformDraw"], c["kU1Draw"], c["kU2Draw"]) == (
            0, kr.NUM_UNIFORM, kr.NUM_UNIFORM + kr.NUM_NORMAL)
        assert (c["kRngUniformRows"], c["kRngNormalRows"]) == (
            kr.NUM_UNIFORM, kr.NUM_NORMAL)
        lanes = header_constants("substep.cuh")["kLanesPerEnv"]
        # a lane's rows 4 k + w cover every row of both blocks
        assert lanes == 4 and c["kGroupSlots"] * lanes >= kr.NUM_NORMAL
        assert kr.NUM_UNIFORM % lanes == 0

    def test_the_butterfly_is_a_transpose(self):
        model = GroupModel(seed_tensor(0), 3)
        v = np.random.default_rng(0).integers(0, 2**32, (4, 4, 3))
        np.testing.assert_array_equal(model.transpose(v),
                                      v.transpose(1, 0, 2))

    @pytest.mark.parametrize("noise", [True, False])
    @pytest.mark.parametrize("b", [1, 7, 1000, 4096])
    def test_reproduces_philox_blocks(self, b, noise):
        seed = seed_tensor(1234 + b)
        want_u, want_n = kr.philox_blocks(seed, b, noise)
        model = GroupModel(seed, b)
        lanes = model.lanes
        # K4: the uniform round, drawn before the step; every lane holds
        # every uniform row
        u = model.call(model.uniform_draw)
        for row in range(model.uniform_rows):
            got = model.uniform(u, row)
            for lane in range(lanes):
                assert torch.equal(bits(got[lane]), want_u[row])
        # K5b: the uniform round transposed, lane w storing rows 4 k + w
        block_u = torch.full((model.uniform_rows, b), -1.0)
        col = model.round(model.uniform_draw)
        for k, row0 in enumerate(range(0, model.uniform_rows, lanes)):
            for lane in range(lanes):
                block_u[row0 + lane] = bits(col[lane, k])
        assert torch.equal(block_u, want_u)
        if not noise:
            # K4 draws no normal: only the uniform round runs
            assert {f for f, _, _ in model.calls} == {model.uniform_draw}
            assert not want_n.any()
            return
        # the normal rounds; lane w computes the normals of rows 4 k + w,
        # which K4 reads on lane i & 3 and K5b stores from lane w
        c1 = model.round(model.u1_draw)
        c2 = model.round(model.u2_draw)
        block_n = torch.full((model.normal_rows, b), float("nan"))
        for k in range(model.slots):
            for lane in range(lanes):
                row = lanes * k + lane
                if row >= model.normal_rows:
                    continue
                assert (c1[lane, k] >= 0).all() and (c2[lane, k] >= 0).all()
                block_n[row] = kr.box_muller(bits(c1[lane, k]),
                                             bits(c2[lane, k]))
        assert torch.equal(block_n, want_n)

    def test_each_draw_is_computed_by_one_lane(self):
        """Every draw a lane uses comes from the one call that holds it,
        computed by one lane of one round; the calls computed twice are the
        two where consecutive rounds overlap (3, the uniform round's last
        lane, and 6, taken half by the u1 and half by the u2 round), and no
        call beyond the 10 the 40 draws need is made."""
        model = GroupModel(seed_tensor(0), 1, provenance=True)
        u = model.call(model.uniform_draw)
        used = {}

        def use(draw, label, who):
            call, word = divmod(int(label), 100)
            assert 4 * call + word == draw, (draw, label)
            used.setdefault(draw, set()).add(who)

        for row in range(model.uniform_rows):
            draw = model.uniform_draw + row
            owner = (draw >> 2) - (model.uniform_draw >> 2)
            for lane in range(model.lanes):
                use(draw, model.uniform(u, row)[lane, 0],
                    (model.uniform_draw, owner))
        for first, rows in ((model.u1_draw, model.normal_rows),
                            (model.u2_draw, model.normal_rows)):
            col = model.round(first)
            for k in range(model.slots):
                for lane in range(model.lanes):
                    row = model.lanes * k + lane
                    if row < rows:
                        call = int(col[lane, k, 0]) // 100
                        use(first + row, col[lane, k, 0],
                            (first, call - (first >> 2)))
        assert sorted(used) == list(range(40))
        assert all(len(who) == 1 for who in used.values())
        computed = {}
        for first, lane, call in model.calls:
            computed.setdefault(call, set()).add((first, lane))
        assert sorted(computed) == list(range(10))
        repeated = {c for c, who in computed.items() if len(who) > 1}
        assert repeated == {3, 6}
        assert computed[3] == {(model.uniform_draw, 3), (model.u1_draw, 0)}
        assert computed[6] == {(model.u1_draw, 3), (model.u2_draw, 0)}


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))

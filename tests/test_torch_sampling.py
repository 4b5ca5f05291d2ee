"""The port's sampler (``repro_torch.serving.sampling``) against the JAX
package's (``repro.serving.sampling``), on shared inputs made with numpy.

* Threefry streams: for seeds {0, 1, 7, 2^31, 2^32-1} × emission indices
  0..63 × the four roles, ``stream_key``'s words and ``stream_uniform``'s
  floats are bit-equal to JAX's, and so are 4,096 seeded-random
  ``(seed, t, role)`` triples.  The port targets JAX's default PRNG mode,
  ``jax_threefry_partitionable=True`` (ROADMAP C1); the flag is read here,
  never set.
* Transforms on float32 logits with ties and -inf entries, V = 1, 7, 1000:
  the top-k and top-p keep masks equal JAX's; ``sampling_probs`` is within
  1e-6 (exp and sums run in another order); ``categorical_from_uniform``
  and ``sample_tokens`` give JAX's tokens.
* ``speculative_accept`` on shared ``p``/``q``/draft gives JAX's
  ``(accepted, emit)`` at T = 0 (exact by construction) and at T = 0.7 and
  1.0; the batched ``round_uniforms`` is bit-equal to one
  ``stream_uniform`` call per role.
* The int32 staging of a step program's sampling inputs round-trips.
* Capturable: on tensors, the sampler brings no host value into the
  computation (``lift_fresh``: a tensor made from Python data, which on the
  card is a host copy a captured program may not make) and reads none back
  (``_local_scalar_dense``, ``nonzero``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.serving import sampling as J
from repro_torch.serving import sampling as T

SEEDS = (0, 1, 7, 2**31, 2**32 - 1)
ROLES = (T.ROLE_SAMPLE, T.ROLE_ACCEPT, T.ROLE_RESIDUAL, T.ROLE_DRAFT)
PROBS_ATOL = 1e-6


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_port_targets_jax_default_prng_mode():
    assert (J.ROLE_SAMPLE, J.ROLE_ACCEPT, J.ROLE_RESIDUAL, J.ROLE_DRAFT) == ROLES
    assert jax.config.jax_threefry_partitionable, (
        "the installed JAX no longer defaults to jax_threefry_partitionable="
        "True, the mode the port's threefry reproduces (ROADMAP C1): the "
        "port's streams would differ from JAX's")


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_key_and_uniform_bit_equal_jax(seed):
    ts = np.arange(64, dtype=np.int32)
    seeds = np.full(64, seed, np.uint32)
    for role in ROLES:
        want_key = np.asarray(jax.vmap(
            lambda t, r=role: J.stream_key(seed, t, r))(jnp.asarray(ts)))
        got_key = T.stream_key(seed, torch.from_numpy(ts), role).numpy()
        assert got_key.dtype == np.int64
        np.testing.assert_array_equal(got_key, want_key.astype(np.int64))
        want = np.asarray(J.stream_uniform(seeds, ts, role))
        got = T.stream_uniform(torch.from_numpy(seeds.view(np.int32)),
                               torch.from_numpy(ts), role).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert ((got >= 0) & (got < 1)).all()


def test_stream_uniform_random_triples_bit_equal_jax():
    rng = np.random.default_rng(2024)
    n = 4096
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ts = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    ts[: n // 2] %= 4096  # emission indices a request reaches
    roles = rng.integers(0, 4, n).astype(np.int32)
    want = np.empty(n, np.float32)
    for role in ROLES:
        sel = roles == role
        want[sel] = np.asarray(J.stream_uniform(seeds[sel], ts[sel], role))
    got = T.stream_uniform(seeds, torch.from_numpy(ts),
                           torch.from_numpy(roles)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _logits(v: int, rows: int, seed: int) -> np.ndarray:
    """float32 logits with ties and -inf entries."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, v)).astype(np.float32) * 2
    x[:, ::3] = np.round(x[:, ::3])            # ties among rounded entries
    if v > 1:
        x[1, 1:] = x[1, 0]                     # a row of equal logits
    if v > 3:
        x[2, : v // 3] = -np.inf               # a third masked out
        x[3, 1::2] = x[3, 0]                   # ties with the first entry
    return x


def _row_params(v: int, rows: int, seed: int):
    rng = np.random.default_rng(seed + 1)
    temp = rng.choice(np.float32([0.0, 0.7, 1.0, 1.3]), rows)
    temp[:2] = (0.0, 0.8)
    top_k = rng.choice(np.int32([0, 1, 3, v, v + 2]), rows).astype(np.int32)
    top_p = rng.choice(np.float32([1.0, 0.95, 0.5, 0.1]), rows)
    return temp, top_k, top_p


V_SIZES = (1, 7, 1000)


@pytest.mark.parametrize("v", V_SIZES)
def test_transform_masks_equal_jax(v):
    x = _logits(v, 12, v)
    _, top_k, top_p = _row_params(v, 12, v)
    for k_ in (top_k, np.int32(0), np.int32(5)):
        want = np.asarray(J.apply_top_k(jnp.asarray(x), jnp.asarray(k_)))
        got = T.apply_top_k(torch.from_numpy(x), torch.as_tensor(k_)).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        np.testing.assert_array_equal(got, want)
    for p_ in (top_p, np.float32(1.0), np.float32(0.9)):
        want = np.asarray(J.apply_top_p(jnp.asarray(x), jnp.asarray(p_)))
        got = T.apply_top_p(torch.from_numpy(x), torch.as_tensor(p_)).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        np.testing.assert_array_equal(got, want)
    t = np.float32([0.0, 0.5, 2.0] * 4)
    np.testing.assert_array_equal(
        T.apply_temperature(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        np.asarray(J.apply_temperature(jnp.asarray(x), jnp.asarray(t))))


@pytest.mark.parametrize("v", V_SIZES)
def test_sampling_probs_and_tokens_equal_jax(v):
    rows = 16
    x = _logits(v, rows, 10 + v)
    temp, top_k, top_p = _row_params(v, rows, 10 + v)
    want = np.array(J.sampling_probs(jnp.asarray(x), temp, top_k, top_p))
    tx = torch.from_numpy(x)
    got = T.sampling_probs(tx, torch.from_numpy(temp), torch.from_numpy(top_k),
                           torch.from_numpy(top_p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_array_equal(got == 0, want == 0)
    greedy = temp == 0
    np.testing.assert_array_equal(got[greedy], want[greedy])  # one-hots
    # the inverse-CDF sampler on shared probabilities and uniforms
    u = np.random.default_rng(v).random(rows, dtype=np.float32)
    u[0], u[1] = 0.0, np.nextafter(np.float32(1), np.float32(0))
    np.testing.assert_array_equal(
        T.categorical_from_uniform(torch.from_numpy(want),
                                   torch.from_numpy(u)).numpy(),
        np.asarray(J.categorical_from_uniform(jnp.asarray(want),
                                              jnp.asarray(u))))
    seed = (np.arange(rows, dtype=np.uint64) * 2654435761 % 2**32
            ).astype(np.uint32)
    t = np.arange(rows, dtype=np.int32) * 3
    want_tok = np.asarray(J.sample_tokens(jnp.asarray(x), seed, t, temp,
                                          top_k, top_p))
    got_tok = T.sample_tokens(tx, torch.from_numpy(seed.view(np.int32)),
                              torch.from_numpy(t), torch.from_numpy(temp),
                              torch.from_numpy(top_k),
                              torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got_tok, want_tok)
    assert got_tok.dtype == np.int32
    np.testing.assert_array_equal(got_tok[greedy], x[greedy].argmax(-1))


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.0])
def test_speculative_accept_equals_jax(temp):
    b, k, v = 6, 4, 40
    w = k + 1
    rng = np.random.default_rng(int(temp * 10))
    lp = rng.normal(size=(b, w, v)).astype(np.float32)
    # the draft is the target plus noise: accepts and rejects both happen
    lq = lp[:, :k] + rng.normal(size=(b, k, v)).astype(np.float32) * 0.7
    temps = np.full(b, temp, np.float32)
    top_k = np.int32([0, 8, 0, 3, 0, 0])
    top_p = np.float32([1.0, 1.0, 0.9, 1.0, 0.6, 1.0])
    p = np.array(J.sampling_probs(jnp.asarray(lp), temps[:, None],
                                  top_k[:, None], top_p[:, None]))
    q = np.array(J.sampling_probs(jnp.asarray(lq), temps[:, None],
                                  top_k[:, None], top_p[:, None]))
    seed = np.uint32([3, 99, 2**31 + 5, 7, 2**32 - 1, 12])
    t0 = np.int32([0, 5, 9, 1, 30, 2])
    n_valid = np.int32([5, 5, 3, 1, 4, 0])
    u = np.asarray(J.stream_uniform(seed[:, None], t0[:, None] + np.arange(k),
                                    J.ROLE_DRAFT))
    draft = np.array(J.categorical_from_uniform(jnp.asarray(q),
                                                jnp.asarray(u)))
    want = J.speculative_accept(jnp.asarray(p), jnp.asarray(q),
                                jnp.asarray(draft), seed, t0, n_valid)
    tt = {n: torch.from_numpy(a) for n, a in dict(
        p=p, q=q, draft=draft, t0=t0, n_valid=n_valid,
        seed=seed.view(np.int32)).items()}
    seed64 = tt["seed"].to(torch.int64) & 0xFFFFFFFF
    got = T.speculative_accept(tt["p"], tt["q"], tt["draft"], seed64,
                               tt["t0"], tt["n_valid"])
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    # the same with the round's uniforms drawn in one batched hash
    u_draft, *uniforms = T.round_uniforms(seed64, tt["t0"], tt["n_valid"], k)
    np.testing.assert_array_equal(_bits(u_draft), _bits(u))
    batched = T.speculative_accept(tt["p"], tt["q"], tt["draft"], seed64,
                                   tt["t0"], tt["n_valid"],
                                   uniforms=tuple(uniforms))
    for g, w_ in zip(batched, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    accepted = got[0].numpy()
    live = n_valid > 1
    assert (accepted[live] < n_valid[live] - 1).any()  # a rejection
    assert (accepted > 0).any()
    if temp == 0:  # one-hot p/q: greedy prefix matching
        tgt = lp.argmax(-1)
        for r in range(b):
            a = 0
            while a < max(n_valid[r] - 1, 0) and draft[r, a] == tgt[r, a]:
                a += 1
            assert accepted[r] == a


def test_round_uniforms_equal_one_stream_per_role():
    seed = torch.tensor([0, 2**32 - 1, 77], dtype=torch.int64)
    t0 = torch.tensor([0, 9, 2**20], dtype=torch.int32)
    n_valid = torch.tensor([4, 0, 2], dtype=torch.int32)
    k = 3
    tj = t0[:, None] + torch.arange(k, dtype=torch.int32)
    u_draft, u_acc, u_res, u_bonus = T.round_uniforms(seed, t0, n_valid, k)
    for got, role in ((u_draft, T.ROLE_DRAFT), (u_acc, T.ROLE_ACCEPT),
                      (u_res, T.ROLE_RESIDUAL)):
        assert torch.equal(got, T.stream_uniform(seed[:, None], tj, role))
    assert torch.equal(u_bonus, T.stream_uniform(
        seed, t0 + torch.clamp(n_valid - 1, min=0), T.ROLE_SAMPLE))


class _Req:
    def __init__(self, sampling, n_generated):
        self.sampling, self.generated = sampling, [0] * n_generated


def test_staged_inputs_round_trip_bit_views():
    reqs = [(0, _Req(T.SamplingParams(0.8, 8, 0.9, 2**32 - 1), 5)),
            (2, _Req(T.SamplingParams(), 1))]
    staged = T.stage_rows(reqs, 3)
    assert list(staged) == list(T.STAGED)
    assert all(a.dtype == np.int32 and a.shape == (3,)
               for a in staged.values())
    seed, t, temp, top_k, top_p = T.from_staged(
        *(torch.from_numpy(staged[k]) for k in T.STAGED))
    want = T.batch_rows(reqs, 3)
    np.testing.assert_array_equal(seed.numpy(), want[0].astype(np.int64))
    for got, w in zip((t, temp, top_k, top_p), want[1:]):
        assert got.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(got.numpy(), w)
    # a program's idle rows are greedy: temperature 0.0, top_p 1.0
    idle = {k: torch.full(shape, v, dtype=torch.int32)
            for k, (shape, v) in T.staged_inputs(2).items()}
    _, _, temp, top_k, top_p = T.from_staged(*(idle[k] for k in T.STAGED))
    assert temp.tolist() == [0.0, 0.0] and top_p.tolist() == [1.0, 1.0]
    assert T.all_greedy([reqs[1]]) and not T.all_greedy(reqs)


class _HostTraffic(TorchDispatchMode):
    """Records the ops that move a value between host and device."""

    HOST_OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.HOST_OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_sampler_makes_no_host_copies_or_reads():
    b, k, v = 3, 2, 9
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((b, k + 1, v), generator=gen)
    seed = torch.tensor([1, 2**32 - 1, 7], dtype=torch.int64)
    t0 = torch.tensor([0, 3, 9], dtype=torch.int32)
    n_valid = torch.tensor([3, 1, 0], dtype=torch.int32)
    temp = torch.tensor([0.8, 0.0, 1.0])
    top_k = torch.tensor([0, 3, 5], dtype=torch.int32)
    top_p = torch.tensor([0.9, 1.0, 0.5])
    with _HostTraffic() as mode:
        tok = T.sample_tokens(logits[:, 0], seed, t0, temp, top_k, top_p)
        row = T.sample_tokens(logits[0, :1], seed[:1], t0[:1], temp[:1],
                              top_k[:1], top_p[:1])
        u_draft, *uniforms = T.round_uniforms(seed, t0, n_valid, k)
        q = T.sampling_probs(logits[:, :k], temp[:, None], top_k[:, None],
                             top_p[:, None])
        draft = T.categorical_from_uniform(q, u_draft)
        p = T.sampling_probs(logits, temp[:, None], top_k[:, None],
                             top_p[:, None])
        accepted, emit = T.speculative_accept(p, q, draft, seed, t0, n_valid,
                                              uniforms=tuple(uniforms))
    assert mode.seen == []
    assert tok.shape == (b,) and row.shape == (1,)
    assert accepted.shape == (b,) and emit.shape == (b, k + 1)

"""The plain version of the candidate-score kernel (yolov3_tpu_torch.ops.score_cuda)
against the JAX package on the same bf16 inputs.

References: `masked_scores_pallas(interpret=True)`, whose (a, y, x) output
is re-indexed to the port's (y, x, a), and the score/arg/mask stage of the
default XLA decode (`_decode_topk_scales`, detect_head.py:188-194). Class
args and masks are equal; scores are equal up to 1e-6, the rounding of the
two frameworks' sigmoids. A cell within 1e-6 of conf_thres may fall on
either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.score_pallas import masked_scores_pallas
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.ops.score_cuda import masked_scores, masked_scores_plain

CONF = 0.25
SCORE_ATOL = 1e-6


def make_head(rng, bs, m, na, nc, coarse):
    """bf16 head logits (bs, m, na*(5+nc)). coarse=True draws from a half-integer
    grid, so many class logits tie exactly (pins the lowest-index argmax)."""
    no = nc + 5
    if coarse:
        x = rng.integers(-8, 5, size=(bs, m, na * no)).astype(np.float32) / 2
    else:
        x = rng.normal(-2.0, 2.0, size=(bs, m, na * no)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def xla_score_stage(flat, na, no, conf):
    """_decode_topk_scales' score/arg/mask lines on the (bs, M*na, no) view."""
    v = flat.reshape(flat.shape[0], -1, no)
    obj_sig = jax.nn.sigmoid(v[..., 4].astype(jnp.float32))
    cls_logit_max = jnp.max(v[..., 5:], axis=-1).astype(jnp.float32)
    cls_arg = jnp.argmax(v[..., 5:], axis=-1)
    score = obj_sig * jax.nn.sigmoid(cls_logit_max)
    valid = (score > conf) & (obj_sig > conf)
    return np.asarray(jnp.where(valid, score, -1.0)), np.asarray(cls_arg), np.asarray(score), np.asarray(obj_sig)


def assert_scores_match(got_s, got_a, want_s, want_a, score, obj):
    np.testing.assert_array_equal(got_a, want_a)
    near = (np.abs(score - CONF) <= SCORE_ATOL) | (np.abs(obj - CONF) <= SCORE_ATOL)
    np.testing.assert_array_equal((got_s >= 0)[~near], (want_s >= 0)[~near])
    both = (got_s >= 0) & (want_s >= 0)
    assert both.any()
    np.testing.assert_allclose(got_s[both], want_s[both], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got_s[~both & ~near], -1.0)


CASES = [  # (bs, m, na, nc, coarse)
    (2, 64, 3, 80, False),
    (2, 64, 3, 80, True),
    (1, 600, 3, 80, False),  # several kernel blocks of cells
    (2, 25, 3, 3, True),  # nc=3: the tiny test config's head
]


@pytest.mark.parametrize("bs,m,na,nc,coarse", CASES)
def test_plain_matches_pallas_interpret(bs, m, na, nc, coarse):
    no = nc + 5
    t, j = make_head(np.random.default_rng(m + nc), bs, m, na, nc, coarse)
    got_s, got_a = (a.numpy() for a in masked_scores_plain(t, na, no, CONF))
    s2, a2 = masked_scores_pallas(j, na, no, CONF, interpret=True)  # (bs, na, m)
    want_s = np.asarray(s2).transpose(0, 2, 1).reshape(bs, m * na)  # -> (y, x, a)
    want_a = np.asarray(a2).transpose(0, 2, 1).reshape(bs, m * na)
    _, _, score, obj = xla_score_stage(j, na, no, CONF)
    assert got_s.shape == (bs, m * na) and got_a.dtype == np.int32
    assert_scores_match(got_s, got_a, want_s, want_a, score, obj)


@pytest.mark.parametrize("bs,m,na,nc,coarse", CASES)
def test_plain_matches_xla_decode_stage(bs, m, na, nc, coarse):
    no = nc + 5
    t, j = make_head(np.random.default_rng(m * nc), bs, m, na, nc, coarse)
    got_s, got_a = (a.numpy() for a in masked_scores_plain(t, na, no, CONF))
    want_s, want_a, score, obj = xla_score_stage(j, na, no, CONF)
    assert_scores_match(got_s, got_a, want_s, want_a, score, obj)


def test_wrapper_runs_plain_on_cpu():
    t, _ = make_head(np.random.default_rng(0), 2, 16, 3, 80, True)
    launches = masked_scores.launches
    got = masked_scores(t, 3, 85, CONF)
    want = masked_scores_plain(t, 3, 85, CONF)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert masked_scores.launches == launches


def test_coarse_inputs_tie():
    """The coarse grid really produces tied maxima, including ties off index 0."""
    t, _ = make_head(np.random.default_rng(1), 2, 64, 3, 80, True)
    cls = t.float().reshape(2, -1, 85)[..., 5:]
    n_max = (cls == cls.amax(-1, keepdim=True)).sum(-1)
    assert (n_max > 1).float().mean() > 0.5
    assert (masked_scores_plain(t, 3, 85, CONF)[1] > 0).any()

"""The TPU layout options of the JAX package in the port, on the CPU: the
space-to-depth stem (`s2d_stem`), the padded head (`Detect` raw_pad,
`serving_module(pad_lanes=)`, `decode_topk_nhwc(padded_lanes=)`) and the
5-D-head decode `decode_topk_candidates`.

The JAX package computes these in other layouts for the TPU; the port keeps
each option and computes its function, held here to the JAX function on the
same weights and inputs: the forward at atol 2e-3 / rtol 1e-3
(tests/test_parity_reference.py:133), the candidates and NMS rows at the NMS
bars (boxes 0.1 px, conf 1e-3, :152-153), five train steps at loss rtol 1e-3
and state atol 1e-4 (tests/test_torch_train_step.py's bars). The model is
yolov3 narrowed (width 0.125, depth 0.33), at 128 px for the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve import ANCHORS, CONF, IMGSZ, narrow_yolov3, planted, port_model  # noqa: F401 — fixture
from test_torch_train_step import HYP, OPT_ARGS, assert_states_match
from yolov3_tpu.models.detect_head import decode_topk_candidates as jax_decode_topk_candidates
from yolov3_tpu.models.detect_head import decode_topk_nhwc as jax_decode_topk_nhwc
from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.models.spec import parse_spec as jax_parse_spec
from yolov3_tpu.ops.nms import nms_from_candidates as jax_nms_from_candidates
from yolov3_tpu.train.loss import LossConfig as JaxLossConfig
from yolov3_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolov3_tpu.train.step import init_train_state as jax_init_train_state
from yolov3_tpu.train.step import make_train_step as jax_make_train_step
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.data import synthetic
from yolov3_tpu_torch.models.convert import from_jax_train_state, load_jax_variables
from yolov3_tpu_torch.models.detect_head import Detect, decode_topk_candidates, decode_topk_nhwc
from yolov3_tpu_torch.models.detection import DetectionModel, s2d_eligible
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.ops.nms import nms_from_candidates
from yolov3_tpu_torch.ops.score_cuda import masked_scores_plain
from yolov3_tpu_torch.train.loss import LossConfig
from yolov3_tpu_torch.train.optim import build_optimizer
from yolov3_tpu_torch.train.step import make_train_step
from yolov3_tpu_torch.utils.checkpoint import load_checkpoint

PAD = 128


def frames(n=2, size=IMGSZ, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def assert_rows_match(got, got_n, want, want_n):
    """NMS rows at the NMS bars: n equal, boxes 0.1 px, conf 1e-3, classes equal."""
    np.testing.assert_array_equal(got_n, want_n)
    for b, k in enumerate(want_n):
        np.testing.assert_allclose(got[b, :k, :4], want[b, :k, :4], atol=0.1)
        np.testing.assert_allclose(got[b, :k, 4], want[b, :k, 4], atol=1e-3)
        np.testing.assert_array_equal(got[b, :k, 5], want[b, :k, 5])


def assert_candidates_match(got, want):
    """(boxes, scores, cls, overflow) of the port against the JAX decode: the
    same valid slots in the same order, their scores, boxes and classes."""
    pb, ps, pc, pov = (t.numpy() for t in got)
    jb, js, jc, jov = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(pov, jov)
    valid = js > 0
    np.testing.assert_array_equal(ps > 0, valid)
    np.testing.assert_allclose(ps[valid], js[valid], rtol=0, atol=1e-3)
    np.testing.assert_allclose(pb[valid], jb[valid], atol=0.1)
    np.testing.assert_array_equal(pc[valid], jc[valid])
    return valid


# ---------------------------------------------------------------- s2d_stem


@pytest.fixture(scope="module")
def s2d_pair():
    """(JAX model with s2d_stem, the port's of the same variables with it)."""
    cfg = narrow_yolov3()
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=64, s2d_stem=True)
    variables = jax.tree.map(np.asarray, ref.variables)
    model = load_jax_variables(DetectionModel(parse_spec(cfg), s2d_stem=True), variables).eval()
    return ref, model, cfg


def test_s2d_forward_matches_jax(s2d_pair):
    ref, model, _ = s2d_pair
    assert ref.s2d_stem and model.s2d_stem and s2d_eligible(model.spec)
    x = frames().astype(np.float32) / 255.0
    want = ref(jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        fused = model.fuse()
        got_fused = fused(torch.from_numpy(x))
    assert fused.s2d_stem
    want_fused = ref.fuse()(jnp.asarray(x))
    for g, w, gf, wf in zip(got, want, got_fused, want_fused):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=2e-3, rtol=1e-3)


def jax_step(spec, variables, s2d):
    """(step, state) of the JAX package's train step on its s2d or plain graph."""
    ref = JaxModel(spec, variables, dtype=jnp.float64, s2d_stem=s2d)
    tx, _, _ = jax_build_optimizer("sgd", ref.params, HYP, **OPT_ARGS)
    cfg = JaxLossConfig.from_model(ref.spec, HYP)
    assert ref.module.s2d_stem == s2d
    return jax_make_train_step(ref.module, cfg, tx), jax_init_train_state(ref, tx, loss_cfg=cfg)


def test_s2d_train_steps_match_jax(s2d_pair):
    """Five train steps with s2d_stem from one state, in float64 (float32
    steps of this narrowed yolov3 grow any rounding difference every step, as
    tests/test_torch_zoo_train.py finds for yolov5s): each step's loss and
    its parts at rtol 1e-3 against the JAX step of its s2d graph, the state
    at atol 1e-4 against the JAX step of the plain graph, the function the
    s2d graph re-expresses.

    The JAX s2d step is not held at 1e-4: its grouped BatchNorm takes the
    stem's statistics in float32 as E[x^2] - mean^2 even under x64
    (yolov3_tpu/nn/modules.py:176-178), so it stands 3.5e-5 from the JAX
    plain step after one step and 4.3e-4 after five. The port's state must
    stand no farther from it than the JAX plain step does, plus 1e-4."""
    ref, _, cfg = s2d_pair
    with jax.enable_x64(True):
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), ref.variables)
        s2d_step, s2d_state = jax_step(ref.spec, variables, True)
        plain_step, plain_state = jax_step(ref.spec, variables, False)
        model = load_jax_variables(DetectionModel(parse_spec(cfg), s2d_stem=True), variables).double()
        optimizer, _, _ = build_optimizer("sgd", model, HYP, **OPT_ARGS)
        # compute_dtype float32 means no autocast; the model casts its input to its own float64
        step = make_train_step(model, LossConfig.from_model(model.spec, HYP), optimizer,
                               compute_dtype=torch.float32)
        rng = np.random.default_rng(1)
        imgs = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
        targets = np.zeros((2, 4, 5), np.float32)
        targets[:, 0] = [0, 0.5, 0.5, 0.4, 0.4]
        targets[:, 1] = [1, 0.25, 0.3, 0.2, 0.3]
        mask = np.zeros((2, 4), bool)
        mask[:, :2] = True
        for i in range(5):
            s2d_state, s2d_metrics = s2d_step(s2d_state, imgs, targets, mask)
            plain_state, _ = plain_step(plain_state, imgs, targets, mask)
            metrics = step(imgs, targets, mask)
            for key in ("loss", "lbox", "lobj", "lcls"):
                np.testing.assert_allclose(float(metrics[key]), float(s2d_metrics[key]), rtol=1e-3,
                                           err_msg=f"{key} {i}")
            got = assert_states_match(step.state, plain_state)
            want, plain = from_jax_train_state(s2d_state), from_jax_train_state(plain_state)
            for key, w in want.items():
                if not isinstance(w, int):
                    bar = float((plain[key] - w).abs().max()) + 1e-4
                    assert float((got[key].float() - w).abs().max()) <= bar, (key, i)
    assert step.state.model.s2d_stem and got["step"] == 5


@pytest.mark.parametrize("build", ["from_config", "constructor"])
def test_ineligible_stem_raises_jax_value_error(build):
    """yolov3-tiny's maxpool stem: the same ValueError, word for word, in both packages."""
    with pytest.raises(ValueError) as want:
        if build == "from_config":
            JaxModel.from_config("yolov3-tiny", imgsz=64, s2d_stem=True)
        else:
            JaxModel(jax_parse_spec("yolov3-tiny"), {}, s2d_stem=True)
    with pytest.raises(ValueError) as got:
        if build == "from_config":
            DetectionModel.from_config("yolov3-tiny", device="cpu", s2d_stem=True)
        else:
            DetectionModel(parse_spec("yolov3-tiny"), s2d_stem=True)
    assert str(got.value) == str(want.value)
    assert not s2d_eligible(parse_spec("yolov3-tiny")) and s2d_eligible(parse_spec("yolov3-spp"))


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2d_train")
    synthetic.generate(tmp / "shapes", n_images=16, imgsz=64, seed=0, n_val=4)
    return tmp, str(tmp / "shapes" / "dataset.yaml")


@pytest.fixture
def one_thread():
    """Torch on one thread: a CPU train step on several threads adds its
    partial sums in an order that varies from run to run, so two runs of the
    same steps part in their last bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RUN = dict(epochs=1, batch_size=8, imgsz=64, noautoanchor=True, noplots=True, workers=1, seed=0, device="cpu")


def test_train_s2d_stem_runs_and_equals_the_plain_run(shapes, monkeypatch, one_thread):
    """train(s2d_stem=True) runs, trains the plain run's weights in their bits
    (the port computes the same layout) and keeps the flag through resume;
    yolov3-tiny raises the JAX train()'s ValueError."""
    from yolov3_tpu_torch.train import loop

    tmp, data = shapes
    cfg = {**narrow_yolov3(), "nc": 3}
    flags = []
    real = loop.make_train_step

    def spy(model, *a, **k):
        flags.append(model.s2d_stem)
        return real(model, *a, **k)

    monkeypatch.setattr(loop, "make_train_step", spy)
    loop.train(data, cfg=cfg, save_dir=tmp / "s2d", s2d_stem=True, **RUN)
    loop.train(data, cfg=cfg, save_dir=tmp / "plain", **RUN)
    s2d, _ = load_checkpoint(tmp / "s2d" / "weights" / "last")
    plain, _ = load_checkpoint(tmp / "plain" / "weights" / "last")
    assert s2d["model"].keys() == plain["model"].keys()
    for k, v in plain["model"].items():
        assert torch.equal(s2d["model"][k], v), k
    assert (tmp / "s2d" / "results.csv").read_text() == (tmp / "plain" / "results.csv").read_text()
    loop.train(data, cfg=cfg, save_dir=tmp / "s2d", s2d_stem=True, resume=True, **{**RUN, "epochs": 2})
    assert flags == [True, False, True]
    assert (tmp / "s2d" / "results.csv").read_text().count("\n") == 3  # a header and two epochs
    with pytest.raises(ValueError, match="tiny's maxpool stem is not"):
        loop.train(data, cfg="yolov3-tiny", save_dir=tmp / "tiny", s2d_stem=True, **RUN)


def test_cli_s2d_stem_reaches_train(monkeypatch):
    from yolov3_tpu_torch.cli import train as cli
    from yolov3_tpu_torch.train import loop

    seen = {}
    monkeypatch.setattr(loop, "train", lambda *a, **k: seen.update(k) or (0.0, (), None))
    opt = cli.parse_opt(argv=["--device", "cpu", "--s2d-stem", "--cfg", "yolov3"])
    assert opt.s2d_stem
    cli.main(opt)
    assert seen["s2d_stem"] is True


# ----------------------------------------------------- the padded head


def test_padded_serving_module_matches_jax(planted):
    """serving_module(pad_lanes=128): the layout, every lane (the pad lanes at
    -20) and the real lanes equal to the plain raw head."""
    variables, cfg, imgs, _ = planted
    ref = JaxModel(jax_parse_spec(cfg), variables).fuse()
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    want = jax.jit(ref.serving_module(pad_lanes=PAD).apply, static_argnames="train")(ref.variables, x, train=False)
    fused = port_model(variables, cfg).fuse()
    with torch.no_grad():
        got = fused.serving_module(pad_lanes=PAD)(torch.from_numpy(imgs).float() / 255.0)
        plain = fused.serving_module()(torch.from_numpy(imgs).float() / 255.0)
    na, no = fused.spec.na, fused.spec.no
    for g, w, p in zip(got, want, plain):
        assert g.shape == w.shape == (*p.shape[:3], na * PAD)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=1e-3)
        lanes = g.reshape(*g.shape[:3], na, PAD)
        assert (lanes[..., no:] == -20.0).all()
        torch.testing.assert_close(lanes[..., :no].reshape(p.shape), p, atol=1e-5, rtol=1e-5)


def test_detect_raw_pad_keeps_the_unpadded_parameters():
    """The padded layout is a forward option of the one head: the same
    parameters (shapes and keys of the unpadded head), the real lanes equal
    to the raw layout's, the pad lanes at -20."""
    torch.manual_seed(0)
    head = Detect(nc=3, na=3, ch=(8, 16), strides=(8, 16))
    assert {k: tuple(v.shape) for k, v in head.state_dict().items()} == {
        "m.0.weight": (24, 8, 1, 1), "m.0.bias": (24,), "m.1.weight": (24, 16, 1, 1), "m.1.bias": (24,)}
    xs = [torch.randn(2, 8, 4, 4), torch.randn(2, 16, 2, 2)]
    for padded, raw in zip(head(xs, raw_pad=16), head(xs, raw=True)):
        assert padded.shape == (*raw.shape[:3], 48)
        lanes = padded.reshape(*raw.shape[:3], 3, 16)
        torch.testing.assert_close(lanes[..., :8].reshape(raw.shape), raw)
        assert (lanes[..., 8:] == -20.0).all()
    with pytest.raises(ValueError, match="narrower"):
        head(xs, raw_pad=4)


def test_padded_decode_matches_jax_and_the_plain_path(planted):
    variables, cfg, imgs, _ = planted
    ref = JaxModel(jax_parse_spec(cfg), variables).fuse()
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    jfeats = jax.jit(ref.serving_module(pad_lanes=PAD).apply, static_argnames="train")(ref.variables, x, train=False)
    want = jax_decode_topk_nhwc(jfeats, ref.anchors_px, ref.spec.strides, conf_thres=CONF, with_overflow=True,
                                padded_lanes=PAD)
    fused = port_model(variables, cfg).fuse()
    im = torch.from_numpy(imgs).float() / 255.0
    with torch.no_grad():
        feats = fused.serving_module(pad_lanes=PAD)(im)
        raw = fused.serving_module()(im)
    got = decode_topk_nhwc(feats, fused.anchors_px, fused.spec.strides, conf_thres=CONF, with_overflow=True,
                           padded_lanes=PAD)
    valid = assert_candidates_match(got, want)
    assert valid.sum(1).min() > 0 and not got[3].any()
    plain = decode_topk_nhwc(raw, fused.anchors_px, fused.spec.strides, conf_thres=CONF, with_overflow=True)
    for a, b in zip(got, plain):  # the padded layout gives the plain layout's candidates
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    out, n = (t.numpy() for t in nms_from_candidates(*got[:3]))
    w_out, w_n = (np.asarray(a) for a in jax_nms_from_candidates(*want[:3]))
    assert_rows_match(out, n, w_out, w_n)
    assert n.min() > 0


def test_padded_decode_overflow_on_a_dense_scene():
    """The overflow flag through the padded route (cf. the JAX package's
    test_padded_head_overflow_and_dense_scene), with the plain kernel version
    as the score function and with the default one."""
    rng = np.random.default_rng(0)
    nc, na = 80, 3
    raw = rng.normal(-8.0, 0.5, size=(2, 80, 80, na * (nc + 5))).astype(np.float32)
    flat = raw.reshape(2, -1, nc + 5)
    for b, count in [(0, 400), (1, 20)]:
        idx = rng.choice(flat.shape[1], size=count, replace=False)
        flat[b, idx, 4] = 4.0
        flat[b, idx, 5 + rng.integers(0, nc)] = 5.0
    padded = np.full((2, 80, 80, na * PAD), -20.0, np.float32)
    for a in range(na):
        padded[..., a * PAD : a * PAD + nc + 5] = raw[..., a * (nc + 5) : (a + 1) * (nc + 5)]
    want = jax_decode_topk_nhwc([jnp.asarray(padded)], ANCHORS, (8,), (256,), CONF, with_overflow=True,
                                padded_lanes=PAD)
    for score_fn in (masked_scores_plain, None):
        kw = {"score_fn": score_fn} if score_fn else {}
        got = decode_topk_nhwc([torch.from_numpy(padded)], ANCHORS, (8,), (256,), CONF, with_overflow=True,
                               padded_lanes=PAD, **kw)
        assert got[3].tolist() == [True, False]
        assert_candidates_match(got, want)
    with pytest.raises(ValueError, match="padded layout"):
        decode_topk_nhwc([torch.from_numpy(raw)], ANCHORS, (8,), (256,), CONF, padded_lanes=PAD)


# ------------------------------------------------ the 5-D-head decode


def test_decode_topk_candidates_matches_jax(planted):
    """The 5-D eval head through decode_topk_candidates: JAX's candidates in
    JAX's (a, y, x) order, the overflow flag, and the NMS rows, which equal
    the NHWC fast path's."""
    variables, cfg, imgs, _ = planted
    ref = JaxModel(jax_parse_spec(cfg), variables).fuse()
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    jfeats = ref(x)
    want = jax_decode_topk_candidates(jfeats, ref.anchors_px, ref.spec.strides, conf_thres=CONF,
                                      with_overflow=True)
    fused = port_model(variables, cfg).fuse()
    im = torch.from_numpy(imgs).float() / 255.0
    with torch.no_grad():
        feats = fused(im)
        raw = fused(im, raw=True)
    assert feats[0].dim() == 5
    got = decode_topk_candidates(feats, fused.anchors_px, fused.spec.strides, conf_thres=CONF, with_overflow=True)
    valid = assert_candidates_match(got, want)
    assert valid.sum(1).min() > 0
    out, n = (t.numpy() for t in nms_from_candidates(*got[:3]))
    w_out, w_n = (np.asarray(a) for a in jax_nms_from_candidates(*want[:3]))
    assert_rows_match(out, n, w_out, w_n)
    nhwc = decode_topk_nhwc(raw, fused.anchors_px, fused.spec.strides, conf_thres=CONF, with_overflow=True)
    f_out, f_n = (t.numpy() for t in nms_from_candidates(*nhwc[:3]))
    assert_rows_match(out, n, f_out, f_n)


def test_decode_topk_candidates_dense_scene_and_ties():
    """A dense scale overflows in both packages; equal scores (ties) keep the
    (a, y, x) order of lax.top_k, which is not the NHWC path's (y, x, a)."""
    rng = np.random.default_rng(1)
    nc, na = 4, 3
    t = rng.normal(-8.0, 0.5, size=(2, na, 20, 20, nc + 5)).astype(np.float32)
    t[0, :, :, :, 4] = 4.0  # image 0: every cell of every anchor a candidate, equal scores
    t[0, :, :, :, 5] = 5.0
    t[1, 2, 3, 4, 4], t[1, 2, 3, 4, 6] = 4.0, 5.0
    t[1, 0, 9, 9, 4], t[1, 0, 9, 9, 5] = 3.0, 6.0
    want = jax_decode_topk_candidates([jnp.asarray(t)], ANCHORS, (8,), (64,), CONF, with_overflow=True)
    got = decode_topk_candidates([torch.from_numpy(t)], ANCHORS, (8,), (64,), CONF, with_overflow=True)
    assert got[3].tolist() == [True, False]
    assert_candidates_match(got, want)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0])[0], atol=1e-4)  # the tie order too

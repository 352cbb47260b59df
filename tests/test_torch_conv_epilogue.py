"""The fused epilogue of the folded convs: `ops/epilogue_cuda.conv_epilogue`
(csrc/epilogue.cu) and its route in `nn.modules.Conv`.

On the CPU:
- `conv_epilogue_plain` in float32 is the three passes it replaces (the
  bias added to the unbiased conv output, as cuDNN's separate bias pass
  does, the activation, the shortcut added after it), bit for bit;
- the registered op runs the plain version in place on a CPU tensor;
- the route: only a folded conv in eval mode on a CUDA bf16 input,
  with no graph to record, C_out a multiple of 8, an activation the kernel
  computes and a residual in its layout takes it (a fake CUDA tensor stands
  in for the card's);
- the CPU forward of narrow yolov3, yolov3-tiny and yolov5x6 (folded bf16,
  folded f32, unfolded eval and train) equals the forward before the route
  existed, bit for bit;
- torch.export traces a folded bf16 Bottleneck on CUDA (fake) tensors
  through the op's fake: one op a conv, the second with the shortcut;
- the counters, and `/health` reporting them.

On a card (skipped without one): the kernel against the plain version
within one bf16 unit in the last place at yolov3's and yolov5x6's served
shapes (a residual block among them), one launch per folded `Conv` of a
served batch with yolov3's 23 shortcuts counted as `silu_residual`, and the
wrapper refusing tensors outside its layout.

The file imports no JAX. On a card, from the repository's root
(`--noconftest` keeps tests/conftest.py, which imports JAX, out):

    python -m pytest tests/test_torch_conv_epilogue.py -q --noconftest
"""

import json
import threading
import urllib.request

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from chip_smoke import bf16_ulps
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from torch_narrow import narrow_cfg
from yolov3_tpu_torch.models.detection import DetectionModel, cast_for_inference
from yolov3_tpu_torch.nn.activations import AconC, FReLU, hardswish, mish
from yolov3_tpu_torch.nn.modules import Bottleneck, Conv, CrossConv
from yolov3_tpu_torch.ops.epilogue_cuda import ACT_FNS, ACTS, conv_epilogue, conv_epilogue_plain

FAKE_CUDA = torch.device("cuda", 0)


def channels_last(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_plain_is_the_three_passes_in_f32(act, residual):
    x, w = channels_last(2, 16, 9, 9), channels_last(24, 16, 3, 3, seed=1) * 0.1
    bias, r = torch.randn(24, generator=torch.Generator().manual_seed(2)), channels_last(2, 24, 9, 9, seed=3)
    y = F.conv2d(x, w, None, 1, 1)
    before = y.clone()
    want = ACT_FNS[act](y + bias.view(1, -1, 1, 1))
    if residual:
        want = r + want
    got = conv_epilogue_plain(y, bias, act, r if residual else None)
    assert torch.equal(got, want) and torch.equal(y, before)


def test_plain_rounds_once_in_bf16():
    y, bias, r = channels_last(2, 16, 5, 5, dtype=torch.bfloat16), torch.randn(16).bfloat16(), \
        channels_last(2, 16, 5, 5, dtype=torch.bfloat16, seed=1)
    got = conv_epilogue_plain(y, bias, "silu", r)
    want = (r.float() + F.silu(y.float() + bias.float().view(1, -1, 1, 1))).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_on_cpu_runs_the_plain_version_in_place(dtype):
    y, bias = channels_last(2, 8, 4, 4, dtype=dtype), torch.randn(8).to(dtype)
    r = channels_last(2, 8, 4, 4, dtype=dtype, seed=1)
    want = conv_epilogue_plain(y, bias, "leaky_relu", r)
    launches = conv_epilogue.launches
    out = conv_epilogue(y, bias, "leaky_relu", r)
    assert out is y and torch.equal(y, want)
    assert conv_epilogue.launches == launches  # the plain version counts no launch


def test_op_refuses_unknown_activations():
    with pytest.raises(ValueError, match="activation"):
        conv_epilogue(channels_last(1, 8, 2, 2), torch.zeros(8), "mish")


def fake_cuda(t, mode):
    return FakeTensor(mode, t.to("meta"), FAKE_CUDA)


def served_conv(c1=16, c2=16, act=True, **kw):
    return Conv(c1, c2, 3, 1, act=act, fused=True, **kw).eval().to(torch.bfloat16)


ROUTE_CASES = {  # name -> (the conv, how the input and residual differ from the served ones, the route)
    "taken": (lambda: served_conv(), {}, "silu"),
    "identity": (lambda: served_conv(act=False), {}, "identity"),
    "leaky_relu": (lambda: served_conv(act="leakyrelu"), {}, "leaky_relu"),
    "with a residual": (lambda: served_conv(), dict(residual=True), "silu"),
    "float16": (lambda: served_conv().half(), dict(dtype=torch.float16), None),
    "cpu": (lambda: served_conv(), dict(device="cpu"), None),
    "float32": (lambda: served_conv().float(), dict(dtype=torch.float32), None),
    "train mode": (lambda: served_conv().train(), {}, None),
    "graph recorded": (lambda: served_conv(), dict(grad=True), None),
    "odd channels": (lambda: served_conv(c2=20), {}, None),
    "unfolded": (lambda: Conv(16, 16, 3, 1).eval().to(torch.bfloat16), {}, None),
    "hardswish": (lambda: served_conv(act=hardswish), {}, None),
    "mish": (lambda: served_conv(act=mish), {}, None),
    "FReLU": (lambda: served_conv(act=FReLU(16).to(torch.bfloat16)), {}, None),
    "AconC": (lambda: served_conv(act=AconC(16).to(torch.bfloat16)), {}, None),
    "NCHW residual": (lambda: served_conv(), dict(residual="nchw"), "silu"),  # copied into the kernel's layout
    "float32 residual": (lambda: served_conv(), dict(residual=torch.float32), None),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_selection(case):
    make, opt, want = ROUTE_CASES[case]
    conv = make()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dtype = opt.get("dtype", torch.bfloat16)
    x = channels_last(2, 16, 8, 8, dtype=dtype)
    residual = None
    if opt.get("residual"):
        rd = opt["residual"] if isinstance(opt["residual"], torch.dtype) else dtype
        residual = channels_last(2, 16, 8, 8, dtype=rd)
        if opt["residual"] == "nchw":
            residual = residual.contiguous()
    if opt.get("device") != "cpu":
        x = fake_cuda(x, mode)
        residual = None if residual is None else fake_cuda(residual, mode)
    if opt.get("grad"):
        conv.requires_grad_(True)
        assert conv._epilogue_act(x, residual) is None
        return
    with torch.no_grad():
        assert conv._epilogue_act(x, residual) == want
    with torch.inference_mode():
        assert conv._epilogue_act(x, residual) == want


def old_conv_forward(self, x):
    """nn.modules.Conv.forward before the fused epilogue."""
    if self.stats_route and self.training:
        return self.act(self._conv_bn_train(x))
    x = self.conv(x)
    return self.act(x if self.bn is None else self.bn(x))


def old_shortcut_forward(self, x):
    """Bottleneck.forward and CrossConv.forward before the fused epilogue."""
    y = self.cv2(self.cv1(x))
    return x + y if self.add else y


@pytest.mark.parametrize("name", ["yolov3", "yolov3-tiny", "yolov5x6"])
def test_cpu_forward_is_unchanged(monkeypatch, name):
    model = DetectionModel.from_config(narrow_cfg(name), seed=0, device="cpu")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    variants = {"fused bf16": cast_for_inference(model.fuse()), "fused f32": model.fuse(), "eval": model}

    def run():
        with torch.inference_mode():
            outs = {k: m.eval()(x, raw=True) for k, m in variants.items()}
        model.train()
        outs["train"] = model(x)
        model.eval()
        return outs

    state = {k: v.clone() for k, v in model.state_dict().items()}
    new = run()
    model.load_state_dict(state)  # train mode moved the running statistics
    monkeypatch.setattr(Conv, "forward", old_conv_forward)
    monkeypatch.setattr(Bottleneck, "forward", old_shortcut_forward)
    monkeypatch.setattr(CrossConv, "forward", old_shortcut_forward)
    old = run()
    for k in new:
        for a, b in zip(new[k], old[k]):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, k)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic batch"])
def test_export_traces_the_op_on_cuda_tensors(dynamic):
    block = Bottleneck(16, 16, fused=True).eval().to(torch.bfloat16)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    block._apply(lambda t: fake_cuda(t, mode))
    x = fake_cuda(channels_last(2, 16, 8, 8, dtype=torch.bfloat16), mode)
    shapes = ({0: torch.export.Dim("batch", min=1, max=1024)},) if dynamic else None
    with torch.no_grad():
        program = torch.export.export(block, (x,), dynamic_shapes=shapes)
    calls = [n for n in program.graph.nodes if n.target is torch.ops.yolov3_tpu_torch.conv_epilogue.default]
    assert len(calls) == 2
    assert [n.args[2] is not None for n in calls] == [False, True]  # the shortcut goes to cv2's epilogue
    assert [n.args[3] for n in calls] == ["silu", "silu"]
    assert not [n for n in program.graph.nodes if n.target in (torch.ops.aten.silu.default, torch.ops.aten.add.Tensor)]


def test_counters_name_every_route():
    assert set(conv_epilogue.route_launches) == {
        "silu", "silu_residual", "identity", "identity_residual", "leaky_relu", "leaky_relu_residual"}
    assert isinstance(conv_epilogue.launches, int)


def test_health_reports_the_counters(tmp_path):
    from yolov3_tpu_torch import serve
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    model = DetectionModel.from_config(narrow_cfg("yolov3-tiny"), seed=0, device="cpu")
    ckpt = save_checkpoint(tmp_path / "best", {"model": model.state_dict()}, spec=model.spec)
    server = serve.make_server(ckpt, host="127.0.0.1", port=0, imgsz=64, max_batch=1, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            counters = json.loads(r.read())["counters"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert counters["conv_epilogue.launches"] == conv_epilogue.launches
    assert counters["conv_epilogue.route_launches"] == conv_epilogue.route_launches


# --- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda", 0)


# (B, C, H, W, act, residual): yolov3@640 batch 32's largest epilogue, a darknet residual block at
# 160x160, a 20x20 one at 1024 channels; yolov5x6@1280 batch 16's stem output (80 channels), a C3 bottleneck at
# 320x320 (its shortcut), 1280 channels at 20x20; the other activations and odd sizes at small shapes
CARD_SHAPES = [
    (32, 64, 320, 320, "silu", False), (32, 128, 160, 160, "silu", True),
    (32, 1024, 20, 20, "silu", True), (16, 80, 640, 640, "silu", False),
    (16, 80, 320, 320, "silu", True), (16, 1280, 20, 20, "silu", False),
    (3, 24, 7, 5, "identity", False), (3, 24, 7, 5, "leaky_relu", True),
    (3, 40, 9, 9, "silu", True), (1, 8, 1, 1, "identity", True),
]


@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s[:4])) + f"-{s[4]}-{s[5]}")
def test_kernel_against_plain_on_the_card(card, shape):
    B, C, H, W, act, residual = shape
    dtype = torch.bfloat16
    g = torch.Generator(device=card).manual_seed(0)
    y = (torch.randn((B, H, W, C), generator=g, device=card) * 3).to(dtype).permute(0, 3, 1, 2)
    bias = torch.randn((C,), generator=g, device=card).to(dtype)
    r = torch.randn((B, H, W, C), generator=g, device=card).to(dtype).permute(0, 3, 1, 2) if residual else None
    want = conv_epilogue_plain(y, bias, act, r)
    key = act + ("_residual" if residual else "")
    launches, routed = conv_epilogue.launches, conv_epilogue.route_launches[key]
    out = conv_epilogue(y, bias, act, r)
    torch.cuda.synchronize(card)
    assert out is y and conv_epilogue.launches == launches + 1 and conv_epilogue.route_launches[key] == routed + 1
    assert bf16_ulps(y, want) <= 1


def test_wrapper_refuses_other_layouts(card):
    y = torch.zeros((2, 16, 4, 4), device=card, dtype=torch.bfloat16)  # NCHW contiguous
    bias = torch.zeros(16, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        conv_epilogue(y, bias, "silu")
    cl = y.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        conv_epilogue(cl[:, :, :, 1:], bias, "silu")  # not contiguous
    with pytest.raises(ValueError, match="residual"):
        conv_epilogue(cl, bias, "silu", y)
    with pytest.raises(ValueError, match="bf16"):
        conv_epilogue(cl.float(), bias.float(), "silu")
    with pytest.raises(ValueError, match="bias"):
        conv_epilogue(cl, bias[:8], "silu")


@pytest.mark.parametrize("name,imgsz,bs", [("yolov3", 640, 2), ("yolov5x6", 1280, 1), ("yolov3-tiny", 640, 2)])
def test_one_launch_per_folded_conv_of_a_served_batch(card, name, imgsz, bs):
    """The epilogue once a folded `Conv` a served batch, but for the convs
    of a conv -> max-pool pair, which launch `conv_pool` instead: yolov3-tiny's
    first four (ops/conv_pool_cuda.py), none in yolov3 or yolov5x6."""
    from yolov3_tpu_torch import serve
    from yolov3_tpu_torch.ops.conv_pool_cuda import conv_pool

    model = DetectionModel.from_config(name, seed=0, device=card)
    infer = serve.build_batched_infer(model, k_per_scale=serve.topk_per_level(model.spec.nl, imgsz))
    convs = [m for m in infer.serving_model.modules() if isinstance(m, Conv)]
    shortcuts = sum(1 for m in infer.serving_model.modules() if isinstance(m, (Bottleneck, CrossConv)) and m.add)
    pairs = len(infer.serving_model.conv_pool_pairs)
    imgs = torch.randint(0, 256, (bs, imgsz, imgsz, 3), dtype=torch.uint8, device=card)
    infer(imgs)
    launches, routes = conv_epilogue.launches, dict(conv_epilogue.route_launches)
    pool_launches = conv_pool.launches
    infer(imgs)
    torch.cuda.synchronize(card)
    moved = {k: v - routes[k] for k, v in conv_epilogue.route_launches.items()}
    assert conv_epilogue.launches - launches == len(convs) - pairs
    assert conv_pool.launches - pool_launches == pairs
    assert moved["silu_residual"] == shortcuts and moved["silu"] == len(convs) - pairs - shortcuts
    assert (len(convs), shortcuts, pairs) == {"yolov3": (72, 23, 0), "yolov5x6": (159, 32, 0),
                                              "yolov3-tiny": (11, 0, 4)}[name]

"""The reference's networks found by name (``reference/archs/``), the seeded
weights' init rule, the port's counters and what a run hands its readers.

The existing configurations keep their weights bit for bit (held against
the draw as it was written before architectures were looked up by name)
and their FLOP counts to the FLOP; a new architecture enters as new files
alone."""

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from h100_bench.costs.flops import serve_flops, train_step_flops
from h100_bench.drivers import serve_closed_loop, train_step
from h100_bench.lib import port, spec, weights
from h100_bench.lib.outcome import Context
from h100_bench.lib.seeds import sub
from h100_bench.reference import nets
from h100_bench.reference.ops import activations, round_fp8

SEEDS = (3, 2147483647 + 77)


def _oracle_make(shapes, seed, tag, device, init=()):
    """The seeded draw as ``lib/weights.py::make`` had it before the init
    rule: 4-D kernels drawn, ``bn.weight`` and ``running_var`` 1, the rest 0."""
    def std(name, shape):
        for pattern, s in init:
            if pattern in name:
                return float(s)
        return math.sqrt(2.0 / math.prod(shape[1:]))

    kernels = [(n, s) for n, s in shapes if len(s) == 4]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(sub(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n, s in kernels:
        size = math.prod(s)
        out[n] = flat[at: at + size].view(s).mul_(std(n, s))
        at += size
    for n, s in shapes:
        if len(s) != 4:
            one = n.endswith(("bn.weight", "running_var"))
            out[n] = (torch.ones if one else torch.zeros)(s, device=device)
    return {n: out[n] for n, _ in shapes}


def _config(name):
    return spec.load_json(spec.BENCH / "configs" / f"{name}.json")


def _digest(shapes):
    return len(shapes), hashlib.sha256(repr([(n, tuple(s)) for n, s in shapes]).encode()).hexdigest()[:16]


# each tensor list as it was before the lookup by name: its length and a
# digest of its names and shapes in order (the order of the draw)
SHAPES = {("bisenet-r18", True): (142, "b0b9aa162c7eacbf"), ("bisenet-r18", False): (138, "dcb1639e27b5daeb"),
          ("deeplabv2-r101", True): (528, "8ca1ca06704ad87c"), ("bisenet-r18", "D"): (10, "0867c87ae59c4876")}


@pytest.mark.parametrize("name,train", sorted(SHAPES, key=str), ids=str)
def test_tensor_lists_unchanged(name, train):
    model = _config(name)["model"]
    shapes = nets.discriminator_shapes(model) if train == "D" else nets.param_shapes(model, train)
    assert _digest(shapes) == SHAPES[(name, train)]


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["bisenet-r18", "deeplabv2-r101"])
def test_train_weights_bit_for_bit(name, seed):
    """G (and D where adversarial) as the train driver makes them."""
    cfg = _config(name)
    g, d = train_step.make_weights(cfg, seed, "cpu")
    _same(g, _oracle_make(nets.param_shapes(cfg["model"], True), seed, "generator", "cpu", cfg.get("init", ())))
    if cfg["adversarial"]["enabled"]:
        _same(d, _oracle_make(nets.discriminator_shapes(cfg["model"]), seed, "discriminator", "cpu",
                              cfg.get("d_init", ())))
    else:
        assert d is None


@pytest.mark.parametrize("seed", SEEDS)
def test_eval_weights_bit_for_bit(seed):
    """BiSeNet-R18's serving tensors, before their BatchNorm statistics."""
    cfg = _config("bisenet-r18")
    model = cfg["model"]
    shapes = nets.param_shapes(model, False)
    got = weights.make(shapes, seed, "generator", "cpu", cfg["init"], rule=nets.arch(model).init_rule)
    _same(got, _oracle_make(shapes, seed, "generator", "cpu", cfg["init"]))


# the FLOPs of a step or request as counted before the lookup by name
FLOPS = {"r18-adv-train": 5737332243136, "r18-serve-b8": 407134940448, "dlv2-train": 17915764408320}


@pytest.mark.parametrize("cell", sorted(FLOPS))
def test_flops_to_the_flop(cell):
    c = spec.resolve(spec.benchmark(), cell)
    count = train_step_flops if c.traffic["driver"] == "train_step" else serve_flops
    assert count(c.config, c.traffic) == FLOPS[cell]


def test_freeze_bn_is_the_configurations():
    assert _config("deeplabv2-r101")["freeze_bn"] is True and "freeze_bn" not in _config("bisenet-r18")


def test_freeze_bn_mirrors_the_ports_loop():
    """The port's own loop picks the frozen BatchNorm by model name; each
    configuration's ``freeze_bn`` has to say the same until the port's
    configuration carries the choice."""
    loop = (spec.ROOT / "rtda_semanticsegmentation_tpu_torch" / "train" / "loop.py").read_text()
    assert 'freeze_bn=(cfg.model.name == "deeplabv2")' in loop
    for path in sorted((spec.BENCH / "configs").glob("*.json")):
        cfg = spec.load_json(path)
        assert cfg.get("freeze_bn", False) == (cfg["model"]["name"] == "deeplabv2"), path.name


def test_architecture_loaded_once():
    assert spec.arch("bisenet") is spec.arch("bisenet") is nets.arch({"name": "bisenet"})
    assert spec.arch("deeplabv2") is not spec.arch("bisenet")


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_reference_optimizer_matches_torch(kind):
    """Three steps at falling learning rates, with weight decay, against
    PyTorch's own optimizer of that kind, in float64."""
    from h100_bench.reference.train import Optimizer

    gen = torch.Generator().manual_seed(11)
    start = {"w": torch.randn(6, 5, generator=gen, dtype=torch.float64),
             "b": torch.randn(5, generator=gen, dtype=torch.float64)}
    grads = [{k: torch.randn(v.shape, generator=gen, dtype=torch.float64) for k, v in start.items()}
             for _ in range(3)]
    lrs, wd, betas = (1e-2, 5e-3, 2e-3), 0.05, (0.9, 0.99)
    ref = Optimizer(kind, wd, 0.9, betas)
    mine = dict(start)
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    cls = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD}[kind]
    extra = {"momentum": 0.9} if kind == "sgd" else {"betas": betas, "eps": 1e-8}
    theirs = cls(list(params.values()), lr=lrs[0], weight_decay=wd, **extra)
    for lr, g in zip(lrs, grads):
        mine = {k: ref.step(k, mine[k], g[k], lr) for k in mine}
        for group in theirs.param_groups:
            group["lr"] = lr
        for k, p in params.items():
            p.grad = g[k].clone()
        theirs.step()
    for k, p in params.items():
        torch.testing.assert_close(mine[k], p.detach(), rtol=1e-12, atol=1e-14)
        assert not torch.equal(mine[k], start[k])


def test_adamw_keeps_decay_out_of_the_gradient():
    from h100_bench.reference.train import Optimizer

    p, g = torch.ones(3), torch.full((3,), 0.5)
    assert torch.equal(Optimizer("adamw", 0.1).effective(p, g), g)
    assert torch.equal(Optimizer("adam", 0.1).effective(p, g), g + 0.1 * p)
    with pytest.raises(ValueError, match="lamb"):
        Optimizer("lamb", 0.0)


PIN = """
import json, os, threading
from h100_bench.lib import device
stop = threading.Event()
early = threading.Thread(target=stop.wait)
early.start()
keep = device.pin_host(1)
late = threading.Thread(target=stop.wait)
late.start()
tids = os.listdir("/proc/self/task")
seen = {tid: sorted(os.sched_getaffinity(int(tid))) for tid in tids}
stop.set()
early.join(); late.join()
print(json.dumps({"keep": keep, "threads": len(tids), "kept": all(v == keep for v in seen.values())}))
"""


def test_host_pin_keeps_every_thread():
    """``pin_host`` moves the threads already running and those started
    after it onto the CPUs it names, in a process of its own."""
    out = subprocess.run([sys.executable, "-c", PIN], capture_output=True, text=True, cwd=spec.ROOT, timeout=60,
                         env=dict(os.environ, PYTHONPATH=str(spec.ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout)
    assert got == {"keep": [max(os.sched_getaffinity(0))], "threads": got["threads"], "kept": True}
    assert got["threads"] >= 3


def test_host_pin_is_the_cards_alone(capsys):
    """The flagship's ``host_cpus`` pins a run on the card only: a CPU run
    of the cell keeps every CPU it had."""
    from h100_bench import harness

    assert spec.resolve(spec.benchmark(), "r18-adv-train").settings["host_cpus"] == 2
    before = os.sched_getaffinity(0)
    cfg = _config("bisenet-r18")
    over = {"config": {"model": {**cfg["model"], "compute_dtype": "float32"},
                       "augment": {**cfg["augment"], "aug_dtype": "float32"}},
            "traffic": {"batch": 2, "source": [64, 96], "target": [64, 96], "first_steps": 1}}
    argv = ["--workload", "r18-adv-train", "--seed", "2147483719", "--seconds", "0.1", "--trace", "0"]
    assert harness.main(argv, require_card=False, device="cpu", overrides=over) == 0
    assert "kept on CPUs" not in capsys.readouterr().out
    assert os.sched_getaffinity(0) == before


def test_unknown_architecture_names_its_file():
    with pytest.raises(FileNotFoundError, match=r"reference/archs/no_such_net\.py"):
        nets.param_shapes({"name": "no_such_net", "num_classes": 19})


def test_default_rule_leaves_no_tensor_silently_zero():
    assert nets.default_init("a.conv.weight", (8, 4, 3, 3)) is None
    assert nets.default_init("a.bn.weight", (8,)) == 1.0 and nets.default_init("a.bias", (8,)) == 0.0
    with pytest.raises(ValueError, match="mlp.weight"):
        nets.default_init("mlp.weight", (8, 4))
    with pytest.raises(ValueError, match="norm.weight"):
        nets.default_init("norm.weight", (8,))


def test_control_rounds_linear_weights():
    gen = torch.Generator().manual_seed(5)
    x, w = torch.randn(4, 16, generator=gen), torch.randn(8, 16, generator=gen)
    with activations(True):
        got = F.linear(x, w)
    assert torch.equal(got, round_fp8(F.linear(x, round_fp8(w))))
    assert not torch.equal(got, round_fp8(F.linear(x, w)))


def test_counters_by_their_own_names():
    from rtda_semanticsegmentation_tpu_torch.obs import spans

    before = port.counters()
    spans.count("h100_bench_test.launches", 3)
    spans.count("h100_bench_test.launches")
    got = port.counted_since(before)
    assert got["h100_bench_test.launches"] == 4
    assert all(v == 0 for k, v in got.items() if k != "h100_bench_test.launches")


def test_outcome_carries_config_and_traffic():
    c = spec.resolve(spec.benchmark(), "r18-serve-b8")
    config = {**c.config, "model": {**c.config["model"], "compute_dtype": "float32"}, "serve_precision": "f32"}
    traffic = {**c.traffic, "batch": 2, "size": [64, 96], "warmup_rounds": 1, "sample": 2}
    ctx = Context(cell=c.name, seed=2147483647 + 11, seconds=0.2, trace=False, config=config, traffic=traffic,
                  settings=c.settings, device="cpu")
    out = serve_closed_loop.run(ctx)
    assert out.config == config and out.traffic == traffic
    assert all(isinstance(v, int) for v in out.counters.values())


# --- a new architecture as new files -----------------------------------------

TOY = '''"""A toy segmenter: a 4x4 / stride-4 patch conv, then over each patch's
channels LayerNorm, a Linear, GELU and a Linear to the classes, and a
bilinear resize back to the input."""

import torch.nn.functional as F

from h100_bench.reference.ops import upsample

OPTIMIZER_SKIPS = ()


def init_rule(name, shape):
    if len(shape) >= 2:
        return None
    return 1.0 if name == "norm.weight" else 0.0


def param_shapes(model, train=False):
    c, k = model["width"], model["num_classes"]
    return [("patch.weight", (c, 3, 4, 4)), ("patch.bias", (c,)), ("norm.weight", (c,)), ("norm.bias", (c,)),
            ("mlp.weight", (2 * c, c)), ("mlp.bias", (2 * c,)), ("head.weight", (k, 2 * c)), ("head.bias", (k,))]


def generator(P, stats, train, x, model, momentum=0.9):
    y = F.conv2d(x, P["patch.weight"], P["patch.bias"], 4)
    b, c, h, w = y.shape
    t = F.layer_norm(y.flatten(2).transpose(1, 2), (c,), P["norm.weight"], P["norm.bias"])
    t = F.linear(F.gelu(F.linear(t, P["mlp.weight"], P["mlp.bias"])), P["head.weight"], P["head.bias"])
    return upsample(t.transpose(1, 2).reshape(b, -1, h, w), x.shape[2:])
'''

PROBE = '''
import json, torch
from h100_bench.costs.flops import serve_flops, train_step_flops
from h100_bench.drivers import serve_closed_loop, train_step
from h100_bench.lib import scenes, spec
from h100_bench.reference import nets
from h100_bench.reference.serve import logits
from h100_bench.reference.train import follow

cfg = spec.load_json(spec.BENCH / "configs" / "toy-mlp.json")
g, d = train_step.make_weights(cfg, 2147483647 + 5, "cpu")
gen = torch.Generator().manual_seed(1)
frames, labels = scenes.make(2, 32, 48, gen, 19)
states = [gen.get_state()] * 2
out = follow(cfg, g, d, [{"image": frames, "label": labels}] * 2, states, "cpu")
served = logits(cfg, serve_closed_loop.make_weights(cfg, {"size": [32, 48]}, 7, "cpu"), frames)
print(json.dumps({
    "nets": nets.__file__, "mlp_norm": float(g["mlp.weight"].norm()), "head_norm": float(g["head.weight"].norm()),
    "norm_scale": g["norm.weight"].tolist(), "leaves": [k for k in g if not nets.is_buffer(k)],
    "raw_grad": out["raw_grad"], "loss": out["loss"],
    "train_flops": train_step_flops(cfg, {"batch": 2, "source": [32, 48], "target": None}),
    "serve_flops": serve_flops(cfg, {"batch": 2, "size": [32, 48]}),
    "logits": list(served.shape), "finite": bool(torch.isfinite(served).all()),
}))
'''


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A copy of the benchmark with ``reference/archs/toy_mlp.py`` and
    ``configs/toy-mlp.json`` added, and nothing else changed, read in a
    process of its own from the copy."""
    root = tmp_path_factory.mktemp("toy")
    shutil.copytree(spec.BENCH, root / spec.BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    (root / spec.BENCH.name / "reference" / "archs" / "toy_mlp.py").write_text(TOY)
    cfg = {k: v for k, v in _config("deeplabv2-r101").items() if k != "freeze_bn"}
    cfg.update(name="toy-mlp", model={"name": "toy_mlp", "num_classes": 19, "width": 16,
                                      "compute_dtype": "float32", "disc_ndf": 64}, init=[])
    (root / spec.BENCH.name / "configs" / "toy-mlp.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True, cwd=root, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["nets"].startswith(str(root))
    return got


def test_toy_weights_follow_its_rule(toy):
    assert toy["mlp_norm"] > 0 and toy["head_norm"] > 0 and toy["norm_scale"] == [1.0] * 16


def test_toy_steps_reach_every_leaf(toy):
    assert sorted(toy["raw_grad"]) == sorted(f"g.{k}" for k in toy["leaves"]) and len(toy["leaves"]) == 8
    assert all(v > 0 for v in toy["raw_grad"].values()), toy["raw_grad"]
    assert len(toy["loss"]) == 2 and all(map(math.isfinite, toy["loss"]))


def test_toy_flops_counted(toy):
    assert toy["train_flops"] > toy["serve_flops"] > 0


def test_toy_serves_logits_of_the_input_size(toy):
    assert toy["logits"] == [2, 19, 32, 48] and toy["finite"]

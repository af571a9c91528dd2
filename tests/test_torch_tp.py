"""The port's tensor parallelism (``parallel/tp.py``) on gloo CPU ranks
(``tests/torch_tp_worker.py``), against one process and against the JAX
package's step on a ``(data=2, model=2)`` mesh.

Setup: BiSeNet-R18 and the FC-Discriminator in f64 at 64 x 96 from the JAX
package's seeded weights bridged into the port, as
``tests/test_torch_distributed.py``; a global batch of 4; the source-only
binned-Lovász step (Adam) and the flagship ``bisenet_adversarial_lovasz``
step without augmentation; ``min_channels=128``, the JAX package's
``tests/test_train_steps.py`` value, so the spatial path's second and third
convs, the ResNet's layer2-4 convs and downsamples, both ARM convs and D's
conv2-4 are sharded. Three runs start with the module's first test (each
within the ``Spawn`` harness's 240 s): 4 ranks at (data=2, model=2), 2
ranks at (data=1, model=2), and ``cli/train_adversarial.main --mesh_model
2`` on 2 ranks resuming a single-process run's checkpoint. Their files
(f64 states and checkpoints) are removed when the module ends.

Tolerances, each with its reason:

- the ranks against one process: each metric rel 1e-10; each parameter and
  BatchNorm running statistic max |diff| <= 1e-10 * max |ref| + 1e-11 per
  tensor, ``test_two_ranks_match_one_process``'s (f64; the sums over ranks
  and the gathered conv slices add in another order);
- the ranks against JAX's (data=2, model=2) ``shard_state`` step (its
  Lovász kernels in Pallas interpret mode):
  ``test_two_ranks_match_jax_data2_mesh``'s tolerances (rel 1e-9 on the
  losses without Lovász and the grad norms, 1e-6 on the rest,
  ``_delta_parity`` at 1e-6 on the parameters, BatchNorm statistics rtol
  1e-9, atol 1e-12);
- the replicated parameters and buffers of the ranks of one model group,
  and the whole G and D every rank gathers: bit for bit, by SHA-256 of
  each tensor (the gradient sum over the world, divided by the model
  size, gives every rank the same bits);
- K1's histogram at (data=1, model=2): bit for bit with one call (its
  integer sums; a sum over the world would double every count);
- the checkpoint written under TP: the same keys and shapes as the
  single-process one, its tensors within the first tolerance, and bit for
  bit what a restore at model 1 loads.
"""

import dataclasses
import json
import os
import shutil

import flax
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_adversarial import _jax_d_flat, _port_d
from test_torch_distributed import REPO, Spawn, _batch, _configs, _jax_mesh_step, assert_matches_jax_step
from test_torch_distributed import x64_module  # noqa: F401  (a fixture)
from test_torch_train import EXEMPT, MAX_ITER, H, W, _jax_variables, _port_model

from rtda_semanticsegmentation_tpu.config import MeshConfig as JMeshConfig
from rtda_semanticsegmentation_tpu.parallel import create_mesh as jcreate_mesh
from rtda_semanticsegmentation_tpu.parallel import tp_shardings as jtp_shardings
from rtda_semanticsegmentation_tpu_torch.cli.predict import main as predict_main
from rtda_semanticsegmentation_tpu_torch.cli import train_adversarial as ttrain_adv
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov
from rtda_semanticsegmentation_tpu_torch.models.convert import to_jax_variables
from rtda_semanticsegmentation_tpu_torch.train.checkpoint import FILENAME, CheckpointManager

import torch_dist_worker as worker

B = 4
MIN_CHANNELS = 128
AUG_SEED = 3
LAYOUTS = {"d2m2": (4, 2), "d1m2": (2, 2)}  # name -> (world, model)
CKPT_LAYOUT = "d2m2"  # the layout whose ranks write and restore a checkpoint
NAMES = ("lovasz", "adv")


def _cli_argv(root, name, extra=()):
    """A tiny flagship job: 64 x 96 synthetic frames, global batch 2, f32."""
    return ["--preset", "bisenet_adversarial_lovasz", "--train_dataset", "synthetic", "--val_dataset", "synthetic",
            "--target_dataset", "synthetic", "--train_size", "64", "96", "--eval_size", "64", "96",
            "--batch_size", "2", "--eval_batch_size", "2", "--steps_per_epoch", "1", "--compute_dtype", "float32",
            "--num_workers", "1", "--device", "cpu", "--no_perf", "--log_backend", "jsonl",
            "--log_dir", os.path.join(root, "logs"), "--checkpoint_dir", os.path.join(root, "cli_ckpt"),
            "--run_name", name, *extra]


@pytest.fixture(scope="module")
def setup(tmp_path_factory, x64_module):
    """The JAX weights, the inputs file, the single-process CLI run and the
    three running spawns."""
    root = str(tmp_path_factory.mktemp("tp"))
    gflat = _jax_variables(3)
    dflat = {k: v.astype(np.float64) for k, v in _jax_d_flat(2).items()}
    configs = {k: v for k, v in _configs().items() if k in NAMES}
    tcfg = configs["adv"][1]
    batches = {name: _batch(7) for name in configs}
    rng = np.random.RandomState(11)
    logits = torch.from_numpy(rng.randn(B, 19, H * W).astype(np.float32) * 3.0)
    labels = torch.from_numpy(rng.randint(0, 19, (B, H * W)).astype(np.int32))
    labels[torch.from_numpy(rng.rand(B, H * W) < 0.1)] = 255
    inputs = {
        "steps": {name: (t, batches[name]) for name, (_, t) in configs.items()},
        "g": _port_model(tcfg, gflat).state_dict(), "d": _port_d(dflat, "float64").state_dict(),
        "max_iter": MAX_ITER, "exempt": EXEMPT, "aug_seed": AUG_SEED, "min_channels": MIN_CHANNELS,
        "hist": (torch.softmax(logits, dim=1).contiguous(), labels), "ckpt_layouts": [CKPT_LAYOUT],
    }
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    script = os.path.join(REPO, "tests", "torch_tp_worker.py")
    spawns = {layout: Spawn(root, world, [script, root, str(model)], tag=layout)
              for layout, (world, model) in LAYOUTS.items()}
    # a single-process job's checkpoint, then the same job resumed under
    # --mesh_model 2 on two ranks for two more epochs ('latest' after epoch 2)
    alone = ttrain_adv.main(_cli_argv(root, "alone", ["--epochs", "1"]))["trainer"]
    code = ("import sys\nfrom rtda_semanticsegmentation_tpu_torch.cli import train_adversarial\n"
            "report = train_adversarial.main(sys.argv[1:])\n"
            "assert report['trainer'].mesh.model_size == 2 and report['global_step'] == 3, report['global_step']\n")
    spawns["cli"] = Spawn(root, 2, ["-c", code, *_cli_argv(root, "tp", [
        "--epochs", "3", "--save_checkpoint_freq_epoch", "1", "--mesh_model", "2",
        "--resume_checkpoint", os.path.join(root, "cli_ckpt", "alone")])], tag="cli")
    yield {"root": root, "gflat": gflat, "dflat": dflat, "configs": configs, "batches": batches,
           "inputs": inputs, "spawns": spawns, "alone": alone}
    for spawn in spawns.values():  # a test that failed before waiting leaves nothing running
        spawn.kill()
    shutil.rmtree(root, ignore_errors=True)  # the f64 states and checkpoints, about 1 GB


def _load(setup, what: str, layout: str, r: int):
    setup["spawns"][layout].wait()
    return torch.load(os.path.join(setup["root"], f"{what}.{layout}.rank{r}.pt"), weights_only=False)


def _one_process(setup, name):
    _, tcfg = setup["configs"][name]
    state, step = worker.build_state(tcfg, setup["inputs"])
    gen = torch.Generator().manual_seed(AUG_SEED)
    state, metrics = step(state, worker.batch_rows(setup["batches"][name], 0, B), gen)
    return state, {k: float(v) for k, v in metrics.items()}


def _assert_close_to(got: dict, ref: dict, what: str) -> None:
    for k, v in ref.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), f"{what} {k}"
            continue
        diff = (got[k] - v).abs().max().item()
        assert diff <= 1e-10 * v.abs().max().item() + 1e-11, f"{what} {k}: {diff}"


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", NAMES)
def test_tp_ranks_match_one_process(setup, name, layout):
    """(a) Every rank's metrics, and the whole G and D it gathers, against
    one process on the whole batch. At (data=1, model=2) a BatchNorm or a
    loss summed over the world instead of the data group fails here."""
    state, ref = _one_process(setup, name)
    world = LAYOUTS[layout][0]
    ranks = [_load(setup, name, layout, r) for r in range(world)]
    for k, v in ref.items():
        assert ranks[0]["metrics"][k] == pytest.approx(v, rel=1e-10, abs=1e-300), k
    assert all(got["metrics"] == ranks[0]["metrics"] for got in ranks)
    for part, module in (("g", state.model), ("d", state.discriminator)):
        if module is not None:
            _assert_close_to(ranks[0][part], module.state_dict(), part)
            # every rank gathers the same whole model, bit for bit
            assert all(got["digests"][part] == ranks[0]["digests"][part] for got in ranks), part


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", NAMES)
def test_replicated_tensors_bit_identical_in_each_model_group(setup, name, layout):
    """(d) The replicated parameters and buffers of the ranks of each model
    group: the same bits (SHA-256 of each tensor)."""
    world, model = LAYOUTS[layout]
    ranks = [_load(setup, name, layout, r)["digests"] for r in range(world)]
    for r in range(world):
        first = ranks[r - r % model]
        for part in ("g_local", "d_local"):
            if first[part] is not None:
                assert first[part] and ranks[r][part] == first[part], f"rank {r} {part}"


@pytest.mark.parametrize("name", NAMES)
def test_tp_ranks_match_jax_data2_model2_mesh(setup, name):
    """(b) The 4 ranks at (data=2, model=2) against JAX's step on a
    (data=2, model=2) mesh built through ``shard_state(..., 128)``."""
    jstate, jm = _jax_mesh_step(setup, name, data=2, model=2, min_channels=MIN_CHANNELS)
    assert_matches_jax_step(setup, name, _load(setup, name, "d2m2", 0), jstate, jm)


def _marked(state_dict: dict, names) -> set:
    """The JAX flat keys that the port's ``names`` (``<conv>.weight``) become."""
    ones = {k: torch.ones_like(v) if k in names else torch.zeros_like(v) for k, v in state_dict.items()}
    return {k for k, v in to_jax_variables(ones).items() if np.any(np.asarray(v) != 0)}


@pytest.mark.parametrize("part", ["g", "d"])
def test_sharded_convs_are_jax_tp_shardings(setup, part):
    """(c) The convs the port shards are the leaves JAX's ``tp_shardings``
    marks ``P(None, None, None, 'model')`` on the same tree."""
    got = _load(setup, "adv", "d2m2", 0)
    names = {f"{n}.weight" for n in got["sharded"][part]}
    assert names and got["sharded"] == _load(setup, "adv", "d2m2", 3)["sharded"]
    ctx = jcreate_mesh(JMeshConfig(data=2, model=2))
    flat = setup["gflat"] if part == "g" else setup["dflat"]
    params = flax.traverse_util.unflatten_dict({tuple(k.split("/")[1:]): v for k, v in flat.items()
                                                if k.startswith("params/")})
    specs = flax.traverse_util.flatten_dict(jtp_shardings(params, ctx, min_channels=MIN_CHANNELS), sep="/")
    want = {f"params/{k}" for k, s in specs.items() if s.spec == jax.sharding.PartitionSpec(None, None, None, "model")}
    assert _marked(got[part], names) == want


def test_k1_histogram_at_data1_model2_is_one_call(setup):
    """(e) Both ranks of (data=1, model=2) hold the whole batch; K1's
    integer histogram summed over the data group is one call's, bit for
    bit (summed over the world, every count would double)."""
    probas, labels = setup["inputs"]["hist"]
    want = klov.lovasz_hist(probas, labels, 256, 255)
    for r in range(2):
        assert torch.equal(_load(setup, "checks", "d1m2", r)["hist"], want)


def test_k1_histogram_at_data2_model2_is_one_call(setup):
    probas, labels = setup["inputs"]["hist"]
    want = klov.lovasz_hist(probas, labels, 256, 255)
    for r in range(4):
        assert torch.equal(_load(setup, "checks", "d2m2", r)["hist"], want)


def _tree_close(got, ref, what: str) -> None:
    """Nested checkpoint trees: the same keys and shapes, tensors within
    the one-process tolerance, everything else equal."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), what
        for k in ref:
            _tree_close(got[k], ref[k], f"{what}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (a, b) in enumerate(zip(got, ref)):
            _tree_close(a, b, f"{what}/{i}")
    elif isinstance(ref, torch.Tensor):
        assert got.shape == ref.shape and got.dtype == ref.dtype, what
        if ref.is_floating_point():
            diff = (got - ref).abs().max().item() if ref.numel() else 0.0
            assert diff <= 1e-10 * ref.abs().max().item() + 1e-11, f"{what}: {diff}"
        else:
            assert torch.equal(got, ref), what
    else:
        assert got == ref, what


def test_tp_checkpoint_is_the_single_process_one(setup, tmp_path):
    """(f) The checkpoint rank 0 wrote at (data=2, model=2) after the
    adversarial step against the one a single process writes after the
    same step: the same tree, keys and shapes (the sharded kernels and
    moments whole). Every rank restored it into a fresh sharded state bit
    for bit; a single process restores it at model 1 to exactly its
    tensors."""
    state, _ = _one_process(setup, "adv")
    _, tcfg = setup["configs"]["adv"]
    cfg = tcfg.replace(train=dataclasses.replace(tcfg.train, checkpoint_dir=str(tmp_path)))
    CheckpointManager(cfg, run_name="one", device="cpu").save_periodic(state, 0, 7)
    ref = torch.load(os.path.join(tmp_path, "one", "latest", FILENAME), weights_only=False)
    shutil.rmtree(tmp_path / "one")
    path = os.path.join(setup["root"], f"ckpt.{CKPT_LAYOUT}", "tp", "latest", FILENAME)
    setup["spawns"][CKPT_LAYOUT].wait()
    got = torch.load(path, weights_only=False)
    _tree_close(got, ref, CKPT_LAYOUT)
    for r in range(LAYOUTS[CKPT_LAYOUT][0]):
        assert _load(setup, "checks", CKPT_LAYOUT, r)["ckpt"] == {"step": 1, "equal": True}, r
    fresh, _ = worker.build_state(tcfg, setup["inputs"])
    restored, meta = CheckpointManager(cfg, run_name="one", device="cpu").restore_from_path(fresh, path)
    assert meta["epoch"] == 0 and restored.step == 1
    assert worker.same(restored.model.state_dict(), got["generator"])
    assert worker.same(restored.d_optimizer.state_dict(), got["d_optimizer"])


def test_cli_mesh_model_2_resumes_and_serves(setup, tmp_path):
    """(g) ``cli/train_adversarial.main --device cpu --mesh_model 2`` on two
    gloo ranks resumed a single-process run's checkpoint (epoch 1) and
    trained epochs 2 and 3; its start line names the layout; its 'latest'
    checkpoint (epoch 2) serves through ``predict --checkpoint_dir`` with
    the masks of that checkpoint restored at model 1."""
    setup["spawns"]["cli"].wait()
    root = setup["root"]
    log = open(os.path.join(root, "log.clirank0")).read()
    assert "backend=gloo world=2 mesh=1x2" in log and "resumed from epoch 0" in log, log[-2000:]
    events = [json.loads(line) for line in open(os.path.join(root, "logs", "tp.jsonl"))]
    assert any(e["event"] == "summary" for e in events)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (64, 96, 3), np.uint8) for _ in range(2)]
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(frames / f"f{i}.png")
    out = tmp_path / "masks"
    rc = predict_main(["--images", str(frames), "--output", str(out), "--size", "64", "96", "--batch_size", "2",
                       "--precision", "f32", "--checkpoint_dir", os.path.join(root, "cli_ckpt"), "--run_name", "tp",
                       "--restore", "latest", "--device", "cpu"])
    assert rc == 0
    trainer = setup["alone"]  # the single-process job's trainer, at model 1
    _, meta = trainer.ckpt.restore_from_path(trainer.state, os.path.join(root, "cli_ckpt", "tp", "latest"))
    assert meta["epoch"] == 1 and trainer.state.step == 2
    want = trainer.predict(np.stack(imgs))
    for i in range(2):
        np.testing.assert_array_equal(np.asarray(Image.open(out / f"f{i}_trainids.png")), want[i])


def test_shard_state_slices_and_gathers_back():
    """``shard_state`` keeps rank r's contiguous slice of each chosen kernel
    and of its optimizer moments; ``tp_shardings`` follows the JAX rule
    (rank 4, at least ``min_channels``, divisible by the model size)."""
    from rtda_semanticsegmentation_tpu_torch.config import get_preset
    from rtda_semanticsegmentation_tpu_torch.models.factory import build_discriminator, init_discriminator
    from rtda_semanticsegmentation_tpu_torch.parallel import MeshContext, shard_state, tp_shardings
    from rtda_semanticsegmentation_tpu_torch.train.optim import build_discriminator_tx
    from rtda_semanticsegmentation_tpu_torch.train.state import TrainState

    cfg = get_preset("bisenet_adversarial_lovasz")
    d = build_discriminator(cfg.model, device="cpu")
    init_discriminator(d, torch.Generator().manual_seed(0))
    marks = tp_shardings(d, 2, min_channels=256)
    assert {k for k, v in marks.items() if v} == {"conv3.weight", "conv4.weight"}
    assert not any(tp_shardings(d, 1, min_channels=1).values())
    assert not any(tp_shardings(d, 3, min_channels=128).values())  # 128, 256, 512: none divides by 3
    full = {k: v.clone() for k, v in d.state_dict().items()}
    opt = build_discriminator_tx(cfg.adversarial, d)
    d(torch.rand(1, 19, 64, 64)).sum().backward()
    opt.step()
    moments = {k: v.clone() for k, v in opt.state[d.conv4.weight].items()}
    state = TrainState(torch.nn.Sequential(), torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))]), lambda t: 0.0,
                       discriminator=d, d_optimizer=opt)
    mesh = MeshContext(rank=3, world=4, device=torch.device("cpu"), model_size=2)
    after = {k: v.clone() for k, v in d.state_dict().items()}
    shard_state(state, mesh, 256)
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)
    assert torch.equal(d.conv4.weight, after["conv4.weight"][256:]) and d.conv4.shard.lo == 256
    assert torch.equal(d.conv3.weight, after["conv3.weight"][128:]) and d.conv2.shard is None
    assert torch.equal(opt.state[d.conv4.weight]["exp_avg"], moments["exp_avg"][256:])
    shard_state(state, mesh, 256)  # a second call: the same slices
    assert d.conv4.weight.shape[0] == 256 and full["conv1.weight"].shape == d.conv1.weight.shape
    with pytest.raises(ValueError, match="shards plain convs only; conv1.weight"):
        shard_state(TrainState(d, opt, lambda t: 0.0), mesh, 64)

"""The port's data parallelism on ``torch.distributed``: two gloo ranks on
the CPU (``tests/torch_dist_worker.py``, spawned once for the module, with
a 240 s limit) against one process and against the JAX package's step on a
``data=2`` mesh, plus the process-group setup.

Setup: BiSeNet-R18 (and the FC-Discriminator) in f64 at 64 x 96 from the
JAX package's seeded weights bridged into the port; a global batch of 4, 2
rows a rank; steps: the source-only binned-Lovász step (Adam), the
flagship ``bisenet_adversarial_lovasz`` step without augmentation and with
``all_four_combined`` (both Adam).

Tolerances, each with its reason:

- two ranks against one process: each metric rel 1e-10; each parameter
  and BatchNorm running statistic max |diff| <= 1e-10 * max |ref| + 1e-11
  per tensor (f64; the ranks sum the BatchNorm moments and the gradients in
  another order; the Lovász histograms are integer sums, the same bits).
  The 1e-11 floor is for the ARM convs' biases, whose gradient is zero in
  exact arithmetic (the gate BatchNorm subtracts them again): one Adam
  step moves them from 0 by rounding noise alone, about 1e-12. Both ranks
  end with the same bits;
- two ranks against JAX's step on a ``data=2`` mesh (its Lovász kernels in
  Pallas interpret mode, per shard under ``shard_map``): the tolerances of
  ``tests/test_torch_adversarial.py``'s f64 step parity: rel 1e-9 on
  ``loss_d``, ``loss_adv_g``, ``loss_ce``, ``grad_norm``, ``grad_norm_d``;
  rel 1e-6 on ``loss_lovasz``, the losses that contain it, ``lr`` and
  ``lr_d``; ``_delta_parity`` at 1e-6 on the parameters; BatchNorm
  statistics rtol 1e-9, atol 1e-12;
- the exact-sort Lovász loss and the per-image CE over two ranks against
  one process: rel 1e-12, loss and gradient (f64, sums in another order);
- K1's histogram summed over the ranks against one call on the whole
  batch, the eval confusion matrix and image count over two ranks against
  one: exact; the eval loss rel 1e-6 (the eval step's per-image losses are
  f32, summed over the images in another order).
"""

import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import time

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adversarial import _cfgs as _adv_cfgs
from test_torch_adversarial import _flat_params, _jax_d_flat, _jax_state, _port_d
from test_torch_train import EXEMPT, MAX_ITER, H, W, _jax_variables, _port_flat, _port_model, _unflat
from test_torch_train import _cfgs as _source_cfgs
from test_train_parity import _delta_parity

from rtda_semanticsegmentation_tpu.config import MeshConfig as JMeshConfig
from rtda_semanticsegmentation_tpu.ops import losses as jlosses
from rtda_semanticsegmentation_tpu.parallel import create_mesh as jcreate_mesh
from rtda_semanticsegmentation_tpu.parallel import shard_batch
from rtda_semanticsegmentation_tpu.parallel import shard_state as jshard_state
from rtda_semanticsegmentation_tpu.train import steps as jsteps
from rtda_semanticsegmentation_tpu.train.schedule import poly_lr_schedule as jpoly
from rtda_semanticsegmentation_tpu.train.state import ModelState, TrainState as JTrainState
from rtda_semanticsegmentation_tpu.models.factory import build_model as jbuild_model
from rtda_semanticsegmentation_tpu.train.optim import build_generator_tx as jbuild_tx
from rtda_semanticsegmentation_tpu_torch import parallel
from rtda_semanticsegmentation_tpu_torch.config import MeshConfig
from rtda_semanticsegmentation_tpu_torch.kernels import lovasz as klov
from rtda_semanticsegmentation_tpu_torch.models.convert import to_jax_variables
from rtda_semanticsegmentation_tpu_torch.models.factory import build_model
from rtda_semanticsegmentation_tpu_torch.ops import losses as tlosses
from rtda_semanticsegmentation_tpu_torch.train.evaluate import evaluate, make_eval_step
from rtda_semanticsegmentation_tpu_torch.data.loader import eval_batches

import torch_dist_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B = 2, 4
SPAWN_TIMEOUT = 240.0
AUG_SEED = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(seed: int) -> dict:
    """A global batch of 4 uint8 64 x 96 source and target frames, labels
    with 10% ignore."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 19, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.1] = 255
    return {"image": rng.randint(0, 256, (B, H, W, 3), np.uint8), "label": labels,
            "target_image": rng.randint(0, 256, (B, H, W, 3), np.uint8)}


def _configs() -> dict:
    """name -> (JAX config or None, port config) of each step."""
    jsrc, tsrc = _source_cfgs("lovasz")
    jadv, tadv = _adv_cfgs("adversarial_lovasz")
    aug = tadv.replace(augment=dataclasses.replace(tadv.augment, pipeline="all_four_combined"))
    return {"lovasz": (jsrc, tsrc), "adv": (jadv, tadv), "adv_aug": (None, aug)}


class Spawn:
    """``world`` ranks of ``cmd`` (default: ``tests/torch_dist_worker.py
    <root>``, 2 ranks), started at once and awaited on first use, within
    ``SPAWN_TIMEOUT`` of the start; their logs are ``<root>/log.<tag>rank<r>``."""

    def __init__(self, root, world: int = WORLD, cmd=None, tag: str = ""):
        self.root, self.done, self.world, self.tag = str(root), False, world, tag
        cmd = cmd or [os.path.join(REPO, "tests", "torch_dist_worker.py"), self.root]
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
        self.procs = []
        for r in range(world):
            log = open(os.path.join(self.root, f"log.{tag}rank{r}"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, *cmd],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log, stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + SPAWN_TIMEOUT

    def wait(self) -> None:
        if self.done:
            return
        try:
            for p in self.procs:
                p.wait(timeout=max(0.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.kill()
            pytest.fail(f"the {self.world}-rank run did not end within {SPAWN_TIMEOUT} s")
        logs = [open(os.path.join(self.root, f"log.{self.tag}rank{r}")).read() for r in range(self.world)]
        assert all(p.returncode == 0 for p in self.procs), "\n".join(log[-3000:] for log in logs)
        self.done = True

    def kill(self) -> None:
        """End every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def load(self, name: str, r: int):
        self.wait()
        return torch.load(os.path.join(self.root, f"{name}.rank{r}.pt"), weights_only=False)


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, x64_module):
    """The JAX weights, the inputs file and the running spawn."""
    root = tmp_path_factory.mktemp("dist")
    gflat = _jax_variables(3)
    dflat = {k: v.astype(np.float64) for k, v in _jax_d_flat(2).items()}
    configs = _configs()
    tcfg = configs["adv"][1]
    batches = {name: _batch(7) for name in configs}
    rng = np.random.RandomState(11)
    logits = torch.from_numpy(rng.randn(B, 19, H * W).astype(np.float32) * 3.0)
    labels = torch.from_numpy(rng.randint(0, 19, (B, H * W)).astype(np.int32))
    labels[torch.from_numpy(rng.rand(B, H * W) < 0.1)] = 255
    val_labels = rng.randint(0, 19, (6, H, W)).astype(np.int32)
    val_labels[rng.rand(6, H, W) < 0.1] = 255
    inputs = {
        "steps": {name: (t, batches[name]) for name, (_, t) in configs.items()},
        "g": _port_model(tcfg, gflat).state_dict(), "d": _port_d(dflat, "float64").state_dict(),
        "max_iter": MAX_ITER, "exempt": EXEMPT, "aug_seed": AUG_SEED,
        "hist": (torch.softmax(logits, dim=1).contiguous(), labels),
        "val": (rng.randint(0, 256, (6, H, W, 3), np.uint8), val_labels), "eval_batch": 4,
    }
    loss_labels = torch.from_numpy(rng.randint(0, 19, (B, 8, 12)).astype(np.int64))
    loss_labels[torch.from_numpy(rng.rand(B, 8, 12) < 0.1)] = 255
    loss_labels[1] = 255  # an image without a valid pixel
    inputs["losses"] = (torch.from_numpy(rng.randn(B, 19, 8, 12) * 2.0), loss_labels)
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    spawn = Spawn(root)
    yield {"gflat": gflat, "dflat": dflat, "configs": configs, "batches": batches, "inputs": inputs, "spawn": spawn}
    spawn.kill()  # a test that failed before waiting leaves nothing running
    shutil.rmtree(root, ignore_errors=True)  # the ranks' f64 states, about 1 GB


def _one_process(setup, name):
    """The same step in one process on the whole global batch."""
    _, tcfg = setup["configs"][name]
    state, step = worker.build_state(tcfg, setup["inputs"])
    state, metrics = step(state, worker.batch_rows(setup["batches"][name], 0, B), torch.Generator().manual_seed(AUG_SEED))
    return state, {k: float(v) for k, v in metrics.items()}


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.max(np.abs(ref))
    return float(np.max(np.abs(got - ref)) / scale) if scale else float(np.max(np.abs(got)))


@pytest.mark.parametrize("name", ["lovasz", "adv", "adv_aug"])
def test_two_ranks_match_one_process(setup, name):
    state, ref = _one_process(setup, name)
    ranks = [setup["spawn"].load(name, r) for r in range(WORLD)]
    for k, v in ref.items():
        assert ranks[0]["metrics"][k] == pytest.approx(v, rel=1e-10, abs=1e-300), k
    for part, module in (("g", state.model), ("d", state.discriminator)):
        if module is None:
            continue
        for k, v in module.state_dict().items():
            if not v.is_floating_point():
                assert torch.equal(ranks[0][part][k], v), k
                continue
            diff = (ranks[0][part][k] - v).abs().max().item()
            assert diff <= 1e-10 * v.abs().max().item() + 1e-11, f"{part} {k}: {diff}"
            assert torch.equal(ranks[0][part][k], ranks[1][part][k]), f"{part} {k} differs between the ranks"
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


def _jax_mesh_step(setup, name, data: int = WORLD, model: int = 1, min_channels: int = 256):
    """JAX's step on a (data, model) mesh of the virtual CPU devices (a
    data=2 mesh by default), the state placed by ``shard_state``, the
    Lovász kernels in Pallas interpret mode."""
    jcfg, _ = setup["configs"][name]
    batch = setup["batches"][name]
    ctx = jcreate_mesh(JMeshConfig(data=data, model=model))
    gflat, dflat = setup["gflat"], setup["dflat"]
    if jcfg.adversarial.enabled:
        state = _jax_state(jcfg, gflat, dflat)
        step = jsteps.make_train_step(jcfg, jpoly(jcfg.optimizer.learning_rate, MAX_ITER),
                                      jpoly(jcfg.adversarial.disc_learning_rate, MAX_ITER), mesh_ctx=ctx)
    else:
        state = JTrainState.create(ModelState.create(
            jbuild_model(jcfg.model).apply, _unflat(gflat), jbuild_tx(jcfg.optimizer, MAX_ITER, decay_exempt=EXEMPT)))
        step = jsteps.make_train_step(jcfg, jpoly(jcfg.optimizer.learning_rate, MAX_ITER), mesh_ctx=ctx)
    keys = ("image", "label", "target_image") if jcfg.adversarial.enabled else ("image", "label")
    sharded = {k: shard_batch(ctx, batch[k]) for k in keys}
    jlosses.FORCE_PALLAS_INTERPRET = True
    try:
        jstate, jm = jax.jit(step)(jshard_state(state, ctx, min_channels), sharded, jax.random.PRNGKey(0))
    finally:
        jlosses.FORCE_PALLAS_INTERPRET = False
    return jstate, {k: float(v) for k, v in jm.items()}


@pytest.mark.parametrize("name", ["lovasz", "adv"])
def test_two_ranks_match_jax_data2_mesh(setup, name):
    jstate, jm = _jax_mesh_step(setup, name)
    assert_matches_jax_step(setup, name, setup["spawn"].load(name, 0), jstate, jm)


def assert_matches_jax_step(setup, name, got, jstate, jm):
    """The port's step (``got``: its metrics and whole G and D) against
    JAX's (its state and metrics), at the tolerances of the module's
    docstring."""
    tm = got["metrics"]
    assert tm.keys() == jm.keys()
    loose = {"lr", "lr_d", "loss", "loss_lovasz", "loss_seg"}
    for k, v in jm.items():
        assert tm[k] == pytest.approx(v, rel=1e-6 if k in loose else 1e-9, abs=1e-300), k
    model = build_model(setup["configs"][name][1].model, device="cpu", train=True).double()
    model.load_state_dict(got["g"])
    ours = _port_flat(model)
    gflat = setup["gflat"]
    before = {k: v for k, v in gflat.items() if k.startswith("params/")}
    g = jstate.generator if hasattr(jstate, "generator") else jstate
    _delta_parity(_unflat(before), _unflat({k: ours[k] for k in before}), _unflat(_flat_params(g.params)),
                  f"{name} G:", rel_tol=1e-6)
    if got["d"] is not None:
        _delta_parity(_unflat(setup["dflat"]), _unflat(to_jax_variables(got["d"])),
                      _unflat(_flat_params(jstate.discriminator.params)), f"{name} D:", rel_tol=1e-6)
    for k, v in flax.traverse_util.flatten_dict(g.batch_stats, sep="/").items():
        np.testing.assert_allclose(ours[f"batch_stats/{k}"], np.asarray(v), rtol=1e-9, atol=1e-12, err_msg=k)


def test_sort_lovasz_and_per_image_ce_over_ranks(setup):
    """The exact-sort Lovász loss (each rank gathers the global
    probabilities) plus the CE ``mean_per_image``: the ranks' shares sum to
    the one-process loss and each rank's rows get the one-process gradient
    (f64, rel 1e-12: the same sums in another order)."""
    logits, labels = setup["inputs"]["losses"]
    x = logits.clone().requires_grad_(True)
    loss = tlosses.lovasz_softmax(torch.softmax(x, dim=1), labels, 255) + \
        tlosses.cross_entropy_with_ignore(x, labels, 255, "mean_per_image")
    loss.backward()
    local = B // WORLD
    for r in range(WORLD):
        got = setup["spawn"].load("checks", r)["losses"]
        assert float(got["loss"]) == pytest.approx(loss.item(), rel=1e-12)
        assert _max_rel(got["grad"], x.grad[r * local:(r + 1) * local]) <= 1e-12


def test_k1_histogram_summed_over_ranks_is_one_call(setup):
    probas, labels = setup["inputs"]["hist"]
    checks = [setup["spawn"].load("checks", r) for r in range(WORLD)]
    want = klov.lovasz_hist(probas, labels, 256, 255)
    assert torch.equal(checks[0]["hist"], want) and torch.equal(checks[1]["hist"], want)


def test_eval_confusion_matrix_over_two_ranks(setup):
    """The eval engine over each rank's slices (6 images in batches of 4,
    the second padded) against one process over all of them, with the
    last step's model."""
    checks = setup["spawn"].load("checks", 0)["eval"]
    _, tcfg = setup["configs"]["adv_aug"]
    model = build_model(tcfg.model, device="cpu", train=True).double()
    model.load_state_dict(setup["spawn"].load("adv_aug", 0)["g"])
    val = worker.Frames(*setup["inputs"]["val"])
    batches = ((torch.from_numpy(i), torch.from_numpy(lab), torch.from_numpy(v))
               for i, lab, v in eval_batches(val, 4, 1))
    ref = evaluate(make_eval_step(tcfg), model, batches, 19)
    assert np.array_equal(checks["hist"], ref["hist"]) and ref["hist"].sum() > 0
    assert (checks["num_images"], checks["batches"]) == (ref["num_images"], ref["batches"]) == (6.0, 2)
    assert checks["loss"] == pytest.approx(ref["loss"], rel=1e-6)


def test_checkpoint_saved_by_rank0_resumes_on_both_ranks(setup):
    for r in range(WORLD):
        ck = setup["spawn"].load("checks", r)["ckpt"]
        assert ck == {"step": 1, "meta_epoch": 0, "g_equal": True, "d_equal": True, "opt_equal": True}, r


def test_sync_any_flag_agrees_over_ranks(setup):
    for r in range(WORLD):
        checks = setup["spawn"].load("checks", r)
        assert checks["flag_one"] is True and checks["flag_none"] is False


def test_ensure_distributed_without_a_launcher_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.ensure_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = parallel.create_mesh(MeshConfig(), device="cpu")
    assert (mesh.rank, mesh.world, mesh.grouped, mesh.device) == (0, 1, False, torch.device("cpu"))
    assert parallel.sync_any_flag(True) is True and parallel.world_size() == 1
    assert parallel.create_mesh(device="cuda").device == torch.device("cuda", 0)


def test_ensure_distributed_raises_when_its_group_cannot_form(monkeypatch):
    """WORLD_SIZE=2 with nobody at the master's address: a raise within the
    timeout, never a run at world 1."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError, match="could not join the gloo process group"):
        parallel.ensure_distributed(device="cpu", timeout_s=1.0)
    assert not torch.distributed.is_initialized() and parallel.world_size() == 1
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT missing"):
        parallel.ensure_distributed(device="cpu")


def test_mesh_checks_its_layout():
    assert parallel.check_mesh(MeshConfig(data=-1), 4) == 4
    with pytest.raises(ValueError, match="mesh.data=2 but the process group has 4"):
        parallel.check_mesh(MeshConfig(data=2), 4)
    with pytest.raises(ValueError, match="mesh.model=2 needs a multiple of 2 ranks .* has 1 rank"):
        parallel.check_mesh(MeshConfig(model=2), 1)
    mesh = parallel.MeshContext(rank=1, world=2, device=torch.device("cpu"))
    assert mesh.check_batch(8) == 4 and mesh.rows(4) == (4, 8)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        mesh.check_batch(7)

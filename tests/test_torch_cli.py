"""The port's train CLIs: the JAX package's flag surface (the same argv
gives the same config), ``--device``, the mesh flags against the process
group's size, a training run on synthetic data, and predicting from the
checkpoint it wrote."""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from rtda_semanticsegmentation_tpu import config as jconfig
from rtda_semanticsegmentation_tpu.cli import common as jcommon
from rtda_semanticsegmentation_tpu_torch import config as tconfig
from rtda_semanticsegmentation_tpu_torch.cli import common as tcommon
from rtda_semanticsegmentation_tpu_torch.cli import train as ttrain
from rtda_semanticsegmentation_tpu_torch.cli import train_adversarial as ttrain_adv
from rtda_semanticsegmentation_tpu_torch.cli.predict import main as predict_main

from test_torch_loop import drop_tmp_path, torch_one_thread  # noqa: E402,F401  (autouse fixtures)

# the JAX fields the port does not carry: none (fast_input is carried; the
# port's plain stems compute its function)
NOT_PORTED = set()
# the port's own SegFormer fields, which the JAX package lacks
PORT_ONLY = {("model", name) for name in tconfig.PORT_ONLY_FIELDS}


def _parse(common, argv, adversarial):
    p = argparse.ArgumentParser()
    common.add_common_flags(p, adversarial)
    args = p.parse_args(argv)
    return common.args_to_config(args, adversarial), args


def _flat(d, prefix=()):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


ARGVS = [
    ([], False),
    (["--model_name", "deeplabv2", "--optimizer", "sgd", "--epochs", "7", "--gta5_dataset_path", "/x/gta",
      "--augmentation", "hflip_only", "--use_lovasz", "--lovasz_bins", "1024", "--lovasz_interp", "0"], False),
    (["--preset", "bisenet_source_small", "--train_dataset", "synthetic", "--val_dataset", "synthetic",
      "--train_size", "64", "96", "--eval_size", "32", "48", "--batch_size", "2", "--steps_per_epoch", "3",
      "--checkpoint_dir", "/c", "--resume_checkpoint", "latest", "--seed", "7", "--run_name", "r",
      "--log_backend", "jsonl", "--log_dir", "/l", "--watch_freq_steps", "2", "--upload_checkpoints",
      "--compute_dtype", "float32", "--eval_batch_size", "3", "--data_echo", "2", "--num_workers", "0",
      "--final_int8_eval", "--profile_steps", "2", "--no_halt_on_nonfinite", "--validate_freq_epoch", "2",
      "--save_checkpoint_freq_epoch", "1", "--log_images_freq_epoch", "3", "--print_freq_batch", "5",
      "--aux_weight", "1.0", "--lovasz_impl", "sort", "--pretrained_backbone", "/b.npz",
      "--bisenet_context_path", "resnet101", "--mesh_data", "1", "--mesh_model", "1"], False),
    (["--preset", "bisenet_adversarial_lovasz", "--generator_model", "bisenet", "--generator_lr", "3e-4",
      "--generator_optimizer", "adam", "--gta5_path", "/g", "--cityscapes_path", "/c", "--disc_downsample", "4",
      "--pretrained_discriminator", "/d.npz", "--mesh_data", "-1"], True),
]


@pytest.mark.parametrize("argv, adversarial", ARGVS)
def test_same_argv_same_config_as_jax(argv, adversarial):
    tcfg, targs = _parse(tcommon, argv, adversarial)
    jcfg, _ = _parse(jcommon, argv, adversarial)
    port, ref = _flat(tcfg.to_dict()), _flat(jcfg.to_dict())
    missing = {k for k in ref if k not in port}
    assert missing == NOT_PORTED
    assert {k for k in port if k not in ref} == PORT_ONLY
    for k, v in port.items():
        if k not in PORT_ONLY:
            assert v == ref[k], k
    assert (tcfg.train_mode, tcfg.train_size, tcfg.eval_size) == (jcfg.train_mode, jcfg.train_size, jcfg.eval_size)
    assert targs.device == "cuda"


def test_defaults_and_presets_match_jax():
    assert tconfig.PRESETS == jconfig.PRESETS + tconfig.PORT_ONLY_PRESETS
    for preset in jconfig.PRESETS:
        port, ref = _flat(tconfig.get_preset(preset).to_dict()), _flat(jconfig.get_preset(preset).to_dict())
        assert {k: v for k, v in ref.items() if k in port} == {k: v for k, v in port.items() if k not in PORT_ONLY}, \
            preset
    assert dataclasses.asdict(tconfig.ObservabilityConfig()) == dataclasses.asdict(jconfig.ObservabilityConfig())


@pytest.mark.parametrize("flag, world, error", [
    (["--mesh_model", "2"], 1, "mesh.model=2 needs a multiple of 2 ranks .* has 1 rank"),
    (["--mesh_data", "2"], 1, "has 1 rank"),
    (["--mesh_data", "2"], 2, None),
    (["--mesh_data", "8"], 2, "has 2 rank"),
    (["--mesh_model", "2"], 4, None),
    (["--mesh_data", "2", "--mesh_model", "2"], 4, None),
    (["--mesh_data", "2", "--mesh_model", "2"], 2, "mesh.data=2 but the process group has 2 rank.*mesh.model=2"),
    (["--mesh_model", "3"], 4, "mesh.model=3 needs a multiple of 3 ranks .* has 4 rank"),
])
def test_multi_device_mesh_raises(flag, world, error, monkeypatch):
    """``--mesh_data`` times ``--mesh_model`` must equal the process
    group's size (a group of ``world`` mocked); a layout that does not fit
    raises, naming both sizes."""
    monkeypatch.setattr(tcommon, "world_size", lambda: world)
    if error is None:
        cfg, args = _parse(tcommon, flag, False)
        want = (args.mesh_data if args.mesh_data is not None else -1, args.mesh_model or 1)
        assert (cfg.mesh.data, cfg.mesh.model) == want
    else:
        with pytest.raises(ValueError, match=error):
            _parse(tcommon, flag, False)


def test_device_cuda_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--preset", "bisenet_source_small", "--train_dataset", "synthetic", "--val_dataset", "synthetic",
            "--checkpoint_dir", str(tmp_path / "c"), "--log_backend", "null"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_adv.main(argv + ["--target_dataset", "synthetic"])


def _train_argv(tmp_path, name, extra=()):
    return ["--train_dataset", "synthetic", "--val_dataset", "synthetic", "--train_size", "32", "32",
            "--eval_size", "32", "32", "--batch_size", "2", "--eval_batch_size", "2", "--epochs", "1",
            "--steps_per_epoch", "2", "--compute_dtype", "float32", "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--log_backend", "jsonl", "--log_dir", str(tmp_path / "logs"), "--run_name", name,
            "--num_workers", "2", "--device", "cpu", *extra]


def test_train_cli_end_to_end_on_cpu(tmp_path):
    report = ttrain.main(_train_argv(tmp_path, "cli_smoke", ["--preset", "bisenet_source_small", "--no_perf"]))
    assert report["global_step"] == 2 and report["trainer"].device.type == "cpu"
    events = [json.loads(line)["event"] for line in open(tmp_path / "logs" / "cli_smoke.jsonl")]
    assert "summary" in events
    report = ttrain_adv.main(_train_argv(tmp_path, "cli_adv", [
        "--preset", "bisenet_adversarial_lovasz", "--target_dataset", "synthetic", "--lambda_adv", "0.01",
        "--disc_lr", "1e-4", "--no_perf"]))
    assert report["global_step"] == 2
    cfg = report["trainer"].cfg
    assert cfg.adversarial.lambda_adv == 0.01 and cfg.adversarial.disc_learning_rate == 1e-4
    assert cfg.data.adversarial_target_dataset == "synthetic" and cfg.train_mode == "adversarial_lovasz"


def test_train_cli_trains_deeplabv2_with_the_final_int8_eval(tmp_path):
    """The ``deeplabv2_cityscapes`` preset (SGD, normalization only, frozen
    BatchNorm affines) through the CLI on synthetic data, then the int8
    evaluation of the best model: its report carries ``int8_miou``, and the
    BatchNorm affines are the initial ones."""
    report = ttrain.main(_train_argv(tmp_path, "deeplab", [
        "--preset", "deeplabv2_cityscapes", "--final_int8_eval", "--no_perf"]))
    assert report["global_step"] == 2
    cfg = report["trainer"].cfg
    assert (cfg.model.name, cfg.optimizer.name, cfg.augment.pipeline) == ("deeplabv2", "sgd", "no_new_aug")
    assert 0.0 <= report["int8_miou"] <= 1.0 and "int8_miou_delta" in report
    model = report["trainer"].model
    bn = model.resnet.layer3_5.conv2.bn
    assert torch.equal(bn.weight, torch.ones_like(bn.weight)) and torch.equal(bn.bias, torch.zeros_like(bn.bias))
    assert not torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))


@pytest.mark.parametrize("restore", ["best", "latest"])
def test_predict_serves_a_trained_checkpoint(tmp_path, restore):
    """Train 2 steps (saving both streams), then predict from the checkpoint:
    the masks equal the restored model's own argmax."""
    report = ttrain.main(_train_argv(tmp_path, "served", [
        "--preset", "bisenet_source_small", "--epochs", "2", "--steps_per_epoch", "1",
        "--save_checkpoint_freq_epoch", "1", "--no_perf"]))
    assert report["global_step"] == 2
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (32, 32, 3), np.uint8) for _ in range(3)]
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(frames / f"f{i}.png")
    out = tmp_path / "masks"
    rc = predict_main(["--images", str(frames), "--output", str(out), "--size", "32", "32", "--batch_size", "2",
                       "--precision", "f32", "--checkpoint_dir", str(tmp_path / "ckpt"), "--run_name", "served",
                       "--restore", restore, "--device", "cpu"])
    assert rc == 0
    trainer = report["trainer"]
    if restore == "latest":  # the final state is the best one's; reload epoch 1's
        trainer.ckpt.restore_into(trainer.state, "latest")
    want = trainer.predict(np.stack(imgs))
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(Image.open(out / f"f{i}_trainids.png")), want[i])

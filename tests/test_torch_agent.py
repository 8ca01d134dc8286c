"""The port's training agent on the CPU: the data loader, the host-side
controllers and the config helpers against the JAX package's (same seeds,
same sequences, equal bytes), checkpoints, the agent's train / validate /
resume / crash-save loop on a tiny configuration, the CLI with a sweep, and
the weight carrier's round trip.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    cli as pcli, config as pconfig, registry as pregistry)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    checkpoint as pckpt, data as pdata, loggers as ploggers, loop as ploop,
    loss as ploss, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.utils import (
    heartbeat as phb, profiling as pprof)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    data as jdata, loss as jloss, state as jstate)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

TINY = dict(netType="LiftingBasedNeuralWaveletv4",
            entropy_layer="conditioned2ZTsepSubbands",
            autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=2,
            batch_size=1, patch_size=32, val_patch_size=32, steps_per_epoch=2,
            max_epoch=2, lambda_=100.0, learning_rate=1e-4, seed=3)


def tiny_cfg(tmp_path, **kw):
    """A tiny flagship-type config with its directories under ``tmp_path``
    and two small validation images on disk."""
    valid = str(tmp_path / "valid")
    pdata.write_corpus(valid, 2, 32, seed=5, kind="plain")
    cfg = pconfig.Config(**dict(TINY, valid_data=valid, **kw)).validate()
    return pconfig._attach_dirs(cfg, str(tmp_path / "experiments"))


# --- data -----------------------------------------------------------------

def test_loader_batches_equal_the_jax_loaders_bytes(tmp_path):
    kw = dict(batch_size=2, patch_size=48, val_patch_size=0, seed=11,
              steps_per_epoch=0)
    for a, b in zip(pdata.synthetic_images(3, 40, seed=2),
                    jdata.synthetic_images(3, 40, seed=2)):
        assert a.tobytes() == b.tobytes()
    # synthetic fallback
    pl, jl = (pdata.ImageDataLoader(pconfig.Config(**kw)),
              jdata.ImageDataLoader(jconfig.Config(**kw)))
    assert pl.steps_per_epoch() == jl.steps_per_epoch() == 16
    got = list(pl.train_batches(3, seed=4))
    want = list(jl.train_batches(3, seed=4))
    assert len(got) == 3 and got[0].shape == (2, 48, 48, 3)
    assert got[0].dtype == np.float32
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
    assert not np.array_equal(got[0], list(pl.train_batches(1, seed=5))[0])
    for a, b in zip(pl.valid_batches(), jl.valid_batches()):
        assert a.shape == (1, 64, 64, 3) and a.tobytes() == b.tobytes()
    # files on disk: small images are upscaled to the patch, eval crops
    d = str(tmp_path / "imgs")
    paths = pdata.write_corpus(d, 3, 40, seed=1)
    assert paths == jdata.write_corpus(d, 3, 40, seed=1)   # idempotent
    assert pdata.list_images([d, ""]) == jdata.list_images([d, ""]) == paths
    kw.update(train_data_1=d, valid_data=d, test_data=d, val_patch_size=32,
              test_patch_size=64)
    pl, jl = (pdata.ImageDataLoader(pconfig.Config(**kw)),
              jdata.ImageDataLoader(jconfig.Config(**kw)))
    assert pl.steps_per_epoch() == jl.steps_per_epoch() == 1
    for a, b in zip(pl.train_batches(2, seed=1), jl.train_batches(2, seed=1)):
        assert a.shape == (2, 48, 48, 3) and a.tobytes() == b.tobytes()
    for mine, theirs, shape in ((pl.valid_batches(), jl.valid_batches(), 32),
                                (pl.test_batches(), jl.test_batches(), 64)):
        mine, theirs = list(mine), list(theirs)
        assert len(mine) == 3 and mine[0].shape == (1, shape, shape, 3)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(mine, theirs))


# --- controllers, config helpers, losses ----------------------------------

def test_plateau_scheduler_matches_jax():
    rng = np.random.RandomState(0)
    # falling, then a long plateau with jitter, then rising
    metrics = np.concatenate([np.linspace(10, 5, 8),
                              5 + 1e-5 * rng.randn(30),
                              np.linspace(5, 9, 40)])
    p, j = pstate.PlateauScheduler(lr=1e-4), jstate.PlateauScheduler(lr=1e-4)
    lrs = [(p.step(float(m)), j.step(float(m))) for m in metrics]
    assert all(a == b for a, b in lrs)
    assert lrs[-1][0] < 1e-4 and min(a for a, _ in lrs) >= 1e-6
    assert p.state_dict() == j.state_dict()
    q = pstate.PlateauScheduler(lr=1.0)
    q.load_state_dict(p.state_dict())
    assert q.step(100.0) == j.step(100.0)


@pytest.mark.parametrize("switch", [0, 1])
def test_loss_switch_matches_jax(switch):
    kw = dict(enabled=(switch == 0), threshold=0.0015)
    p, j = pstate.LossSwitchController(**kw), jstate.LossSwitchController(**kw)
    for mse in (0.1, 0.01, 0.002, 0.0014, 0.5):
        assert p.rate_weight() == j.rate_weight()
        p.observe_window_mse(mse)
        j.observe_window_mse(mse)
    assert p.rate_weight() == j.rate_weight() == 1.0   # on for good
    assert p.state_dict() == j.state_dict()


def test_config_helpers_match_jax(tmp_path):
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                        "flagship_lifting_ztsep.json")
    root_p, root_j = str(tmp_path / "p"), str(tmp_path / "j")
    p = pconfig.process_config(path, root_p)
    j = jconfig.process_config(path, root_j)
    strip = lambda s, root: s.replace(root, "ROOT")  # noqa: E731
    assert strip(pconfig.to_json(p), root_p) == strip(jconfig.to_json(j), root_j)
    subs_p, subs_j = pconfig.expand_sweep(p, root_p), jconfig.expand_sweep(j, root_j)
    assert [strip(pconfig.to_json(c), root_p) for c in subs_p] \
        == [strip(jconfig.to_json(c), root_j) for c in subs_j]
    assert [c.lambda_ for c in subs_p] == [117.3, 435.0, 835.0, 3140.0, 11700.0]
    assert all(os.path.isdir(c.checkpoint_dir) and not c.multi_agent
               for c in subs_p)
    assert subs_p[1].exp_name == "flagship_lifting_ztsep/exp_435.0"
    assert pconfig.expand_sweep(subs_p[0]) == [subs_p[0]]


def test_valid_rd_loss_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.uniform(-0.5, 0.5, (2, 3, 8, 8)).astype(np.float32)
    xhat = (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
    ixe = rng.uniform(0, 8, (2, 3, 2, 2)).astype(np.float32)
    ixo = [rng.uniform(0, 4, (2, 9, 4, 4)).astype(np.float32)]
    want = jloss.valid_rd_loss(jnp.asarray(x), jnp.asarray(xhat),
                               jnp.asarray(ixe), [jnp.asarray(ixo[0])], 0.1)
    got = ploss.valid_rd_loss(torch.from_numpy(x), torch.from_numpy(xhat),
                              torch.from_numpy(ixe),
                              [torch.from_numpy(ixo[0])], 0.1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


# --- utilities ------------------------------------------------------------

def test_heartbeat_is_throttled_and_safe_across_threads(tmp_path, monkeypatch):
    path = str(tmp_path / "hb" / "beat")
    hb = phb.Heartbeat(path, min_interval=3600.0)
    hb.beat()
    first = os.stat(path).st_mtime_ns
    hb.beat()                      # throttled: no write
    assert os.stat(path).st_mtime_ns == first
    with open(path) as fh:
        assert float(fh.read()) > 1e9          # the time of the beat
    errors = []

    def hammer():
        try:
            for _ in range(200):
                hb.beat(force=True)
        except OSError as e:       # a shared temporary name would raise here
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert os.listdir(os.path.dirname(path)) == ["beat"]
    monkeypatch.delenv(phb.ENV_VAR, raising=False)
    phb.Heartbeat().beat(force=True)   # no path configured: a no-op
    monkeypatch.setenv(phb.ENV_VAR, str(tmp_path / "env_beat"))
    phb.Heartbeat().beat()
    assert os.path.exists(str(tmp_path / "env_beat"))


def test_phase_timers_and_loggers(tmp_path):
    t = pprof.PhaseTimers()
    for _ in range(3):
        with t.phase("step"):
            pass
    assert t.counts["step"] == 3 and "step:" in t.report() and "x3" in t.report()
    jsonl = str(tmp_path / "m.jsonl")
    log = ploggers.RDLogger(jsonl_path=jsonl)
    log(3.0, 0.01, 0.5, 1.5)
    log(1.0, 0.03, 0.7, 0.5)
    state = log.state_dict()
    other = ploggers.RDLogger()
    other.load_state_dict(state)
    assert other.meter.means() == log.meter.means()
    assert log.display(lr=1e-4, typ="tr", step=2) == (2.0, 0.02, 0.6, 1.0)
    assert log.meter.rd == []           # display resets the meter
    with open(jsonl) as fh:
        row = json.loads(fh.read())
    assert row["typ"] == "tr" and row["step"] == 2 and row["mse"] == 0.02
    np.testing.assert_allclose(row["psnr"], -10 * np.log10(0.02))


# --- checkpoints ----------------------------------------------------------

def test_checkpoint_is_atomic_and_keeps_model_best(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    assert pckpt.load_checkpoint(d) is None
    one = {"epoch": 1, "w": torch.arange(4.0), "best": float("inf")}
    pckpt.save_checkpoint(d, one, is_best=True)
    two = {"epoch": 2, "w": torch.arange(4.0) + 1, "best": 0.5}
    pckpt.save_checkpoint(d, two)
    assert pckpt.load_checkpoint(d)["epoch"] == 2
    best = pckpt.load_checkpoint(d, "model_best")
    assert best["epoch"] == 1 and best["best"] == float("inf")
    assert torch.equal(best["w"], one["w"])
    assert sorted(os.listdir(d)) == ["checkpoint.pt", "model_best.pt"]

    # a best checkpoint is serialised once and model_best is a copy of it
    calls = []
    real_save = torch.save
    monkeypatch.setattr(torch, "save",
                        lambda *a, **k: (calls.append(1), real_save(*a, **k)))
    pckpt.save_checkpoint(d, two, is_best=True)
    monkeypatch.undo()
    assert len(calls) == 1
    with open(os.path.join(d, "checkpoint.pt"), "rb") as a, \
            open(os.path.join(d, "model_best.pt"), "rb") as b:
        assert a.read() == b.read()
    assert pckpt.load_checkpoint(d, "model_best")["epoch"] == 2

    def torn_save(payload, fh):
        fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError):
        pckpt.save_checkpoint(d, {"epoch": 3})
    monkeypatch.undo()
    assert pckpt.load_checkpoint(d)["epoch"] == 2    # the old file is whole
    assert sorted(os.listdir(d)) == ["checkpoint.pt", "model_best.pt"]


# --- the agent ------------------------------------------------------------

def test_agent_trains_validates_saves_and_resumes(tmp_path):
    cfg = tiny_cfg(tmp_path, profile_steps=1, phase_timers=True)
    agent = ploop.LiftingDWTAgent(cfg, device="cpu")
    assert agent.model_size_estimation() > 1
    agent.run()
    agent.finalize()
    assert (agent.current_epoch, agent.current_iteration) == (1, 4)
    assert np.isfinite(agent.best_valid_loss)
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["checkpoint.pt",
                                                      "model_best.pt"]
    assert os.path.exists(os.path.join(cfg.log_dir, "trace", "trace.json"))
    with open(os.path.join(cfg.summary_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    assert [r["typ"] for r in rows] == ["tr", "va", "tr", "va"]
    assert all(np.isfinite(r["rd"]) for r in rows)
    assert agent.timers.counts["step"] == 4

    # a second agent resumes: counters, lr, weights and Adam moments
    agent.scheduler.lr = 5e-5
    agent.save_checkpoint()
    cfg2 = pconfig.Config(**{**cfg.__dict__, "resume_training": True,
                             "max_epoch": 3, "profile_steps": 0})
    again = ploop.LiftingDWTAgent(cfg2, device="cpu")
    assert (again.current_epoch, again.current_iteration) == (1, 4)
    assert again.scheduler.lr == 5e-5
    assert again.best_valid_loss == agent.best_valid_loss
    for (n, a), (_, b) in zip(agent.model.state_dict().items(),
                              again.model.state_dict().items()):
        assert torch.equal(a, b), n
    old, new = agent.optimizer.state_dict(), again.optimizer.state_dict()
    assert len(new["state"]) == len(old["state"]) > 0
    for k, st in old["state"].items():
        assert torch.equal(st["exp_avg"], new["state"][k]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], new["state"][k]["exp_avg_sq"])
        assert float(st["step"]) == float(new["state"][k]["step"]) == 4
    # the identical next step from both
    batch = torch.from_numpy(next(iter(agent.data.train_batches(1, seed=9)))
                             ).permute(0, 3, 1, 2)
    outs = [a.train_step(batch, torch.Generator().manual_seed(1), 5e-5, 1.0)[0]
            for a in (agent, again)]
    assert float(outs[0].loss) == float(outs[1].loss)
    for a, b in zip(agent.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    # and the resumed run goes on from its counters (epochs 1 and 2)
    again.run()
    assert (again.current_epoch, again.current_iteration) == (2, 8)


def test_agent_falls_back_to_model_best_and_starts_fresh(tmp_path):
    cfg = tiny_cfg(tmp_path, max_epoch=0)
    agent = ploop.LiftingDWTAgent(cfg, device="cpu")
    agent.current_epoch, agent.current_iteration = 7, 70
    agent.save_checkpoint(is_best=True)
    os.remove(pckpt.checkpoint_path(cfg.checkpoint_dir, "checkpoint"))
    cfg2 = pconfig.Config(**{**cfg.__dict__, "resume_training": True})
    again = ploop.LiftingDWTAgent(cfg2, device="cpu")
    assert (again.current_epoch, again.current_iteration) == (7, 70)
    os.remove(pckpt.checkpoint_path(cfg.checkpoint_dir, "model_best"))
    fresh = ploop.LiftingDWTAgent(cfg2, device="cpu")
    assert (fresh.current_epoch, fresh.current_iteration) == (0, 0)


def test_agent_saves_on_a_crash(tmp_path):
    cfg = tiny_cfg(tmp_path, mode="debug")
    agent = ploop.LiftingDWTAgent(cfg, device="cpu")
    step, calls = agent.train_step, []

    def failing(*args):
        if calls:
            raise FloatingPointError("boom")
        calls.append(1)
        return step(*args)

    agent.train_step = failing
    with pytest.raises(FloatingPointError):
        agent.run()
    saved = pckpt.load_checkpoint(cfg.checkpoint_dir)
    assert saved["iteration"] == 1 and saved["epoch"] == 0
    assert len(saved["optimizer"]["state"]) > 0


@pytest.mark.parametrize("mode,item", [("test", "item 13"),
                                       ("train_postprocess", "item 12")])
def test_unported_modes_raise(tmp_path, mode, item, monkeypatch):
    """The two modes that raised until their ROADMAP items were ported now
    run: ``test`` with a ``tile_size`` that divides the two 32-pixel test
    images codes each image in two tiles (item 13's single-device part),
    and ``train_postprocess`` trains the restoration net (item 12)."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
        tiled_coder)
    tiles = []
    real = tiled_coder.TiledCodecCoder.compress_decompress
    monkeypatch.setattr(tiled_coder.TiledCodecCoder, "compress_decompress",
                        lambda self, x: tiles.append(self.n_tiles)
                        or real(self, x))
    cfg = tiny_cfg(tmp_path, mode=mode, tile_size=16, max_epoch=1,
                   resnetlevel=1, postprocess="iwave", test_patch_size=32)
    cfg.test_data = cfg.valid_data
    agent = ploop.LiftingDWTAgent(cfg, device="cpu")
    agent.run()
    if mode == "test":
        assert tiles == [2, 2]
        assert len(agent.last_test_per_image) == 2
    else:
        assert not tiles and agent.pp_model.Conv_0.weight.grad is not None


def test_cli_test_mode_codes_a_real_bitstream(tmp_path, monkeypatch, caplog):
    """The CLI in ``mode: test`` on the checkpoint of a one-step rehearsal:
    each of the two 32x32 test images coded to bytes and back, and the
    real-bitstream line logged."""
    monkeypatch.chdir(tmp_path)
    images = tiny_cfg(tmp_path).valid_data
    raw = dict(TINY, exp_name="bits", max_epoch=1, steps_per_epoch=1,
               valid_data=images, test_data=images, test_patch_size=32)
    for mode in ("train", "test"):
        with open("bits.json", "w") as fh:
            json.dump(dict(raw, mode=mode), fh)
        with caplog.at_level("INFO", logger="lwc_torch"):
            assert pcli.main(["--device", "cpu", "bits.json"]) == 0
    lines = [r.getMessage() for r in caplog.records]
    assert any("restored checkpoint 'model_best'" in ln for ln in lines)
    assert sum(" test image " in ln for ln in lines) == 2
    last = [ln for ln in lines if "total_rate" in ln][-1]
    assert "real bitstream" in last and "avg_psnr" in last


@pytest.mark.parametrize("entropy_layer", [
    "onlyEZWT", "DWTConditioned2EntropyLayerZTBlock"])
def test_cli_trains_resumes_and_codes_the_tree_entropy_models(
        tmp_path, monkeypatch, caplog, entropy_layer):
    """The CLI with onlyEZWT or ZTBlock: a one-epoch run, a resumed epoch
    (its counters and Adam moments restored), then ``mode: test``: each of
    the two 32x32 test images coded to bytes and back."""
    monkeypatch.chdir(tmp_path)
    images = tiny_cfg(tmp_path).valid_data
    raw = dict(TINY, exp_name="tree", entropy_layer=entropy_layer,
               max_epoch=1, steps_per_epoch=1, valid_data=images,
               test_data=images, test_patch_size=32)
    ckpt_dir = os.path.join("experiments", "tree", "checkpoints")
    # the resumed run takes the saved epoch again, then the next one
    for mode, argv, epochs, want in (
            ("train", [], 1, (0, 1)),
            ("train", ["--resume-training"], 2, (1, 3)),
            ("test", [], 2, None)):
        with open("tree.json", "w") as fh:
            json.dump(dict(raw, mode=mode, max_epoch=epochs), fh)
        with caplog.at_level("INFO", logger="lwc_torch"):
            assert pcli.main(["--device", "cpu", *argv, "tree.json"]) == 0
        saved = pckpt.load_checkpoint(ckpt_dir)
        if want:
            steps = {float(st["step"])
                     for st in saved["optimizer"]["state"].values()}
            assert (saved["epoch"], saved["iteration"], steps) \
                == (*want, {float(want[1])})
    lines = [r.getMessage() for r in caplog.records]
    assert any("restored checkpoint 'checkpoint'" in ln for ln in lines)
    assert any("restored checkpoint 'model_best'" in ln for ln in lines)
    assert sum(" test image " in ln for ln in lines) == 2
    last = [ln for ln in lines if "total_rate" in ln][-1]
    assert "real bitstream" in last
    assert any(k.startswith("codecs.0.entropymodel.eb_xo.")
               for k in saved["model"])


def test_unported_options_raise(tmp_path):
    # a mesh needs a batch that divides it, and the process group that the
    # CLI's launcher joins (the mesh run itself: tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="not divisible"):
        ploop.LiftingDWTAgent(tiny_cfg(tmp_path, mesh_shape=(2,)),
                              device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        ploop.LiftingDWTAgent(tiny_cfg(tmp_path, mesh_shape=(2,),
                                       batch_size=2), device="cpu")
    with pytest.raises(KeyError):
        pregistry.get_agent("NoSuchAgent")
    assert pregistry.get_agent("CompressionAgent") is ploop.LiftingDWTAgent
    # steps_per_call is accepted (and ignored)
    agent = ploop.LiftingDWTAgent(
        tiny_cfg(tmp_path, steps_per_call=4, mode="validate_recu_reco"),
        device="cpu")
    agent.run()


def test_cli_runs_a_sweep_and_writes_results(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    raw = dict(TINY, exp_name="tiny", multi_exp_name="sweep", max_epoch=1,
               steps_per_epoch=1, multi_agent=True, multi_param="lambda_",
               lambda_=[50.0, 100.0], mode="train",
               valid_data=tiny_cfg(tmp_path).valid_data,
               cuda=True, autoencoderFlag="SubbandAutoEncoderBerk")
    raw.pop("autoencoder")
    with open("sweep.json", "w") as fh:
        json.dump(raw, fh)
    assert pcli.main(["--device", "cpu", "sweep.json"]) == 0
    with open(os.path.join("experiments", "sweep", "results.json")) as fh:
        results = json.load(fh)
    assert sorted(results) == ["sweep/exp_100.0", "sweep/exp_50.0"]
    assert results["sweep/exp_50.0"]["lambda_"] == 50.0
    assert all(np.isfinite(r["best_valid_loss"]) for r in results.values())
    for name in results:
        assert os.path.exists(os.path.join("experiments", name, "checkpoints",
                                           "checkpoint.pt"))
    assert pcli.main([]) == 2     # usage
    # --resume-training picks the sweep's checkpoints up
    assert pcli.main(["--resume-training", "--device", "cpu", "sweep.json"]) == 0


# --- weights --------------------------------------------------------------

def test_flax_params_round_trip():
    cfg = pconfig.flagship_config(dwtlevels=2)
    model = PCodec(cfg, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    flat = weights.flax_params_from_state_dict(sd)
    key = "['codecs_1']['entropymodel']['plc_0']['Conv_1']['kernel']"
    assert flat[key].shape == (3, 3, 243, 243) and flat[key].dtype == np.float32
    assert all(weights.port_name(k) in sd for k in flat)
    back = weights.state_dict_from_flax(flat)
    assert set(back) == set(sd)
    assert all(torch.equal(back[n], sd[n]) for n in sd)
    other = PCodec(cfg)
    weights.load_flax_params(other, flat)
    tree = weights.unflatten_params(flat)
    assert tree["codecs_1"]["entropymodel"]["plc_0"]["Conv_1"]["kernel"] is flat[key]
    with pytest.raises(KeyError):
        weights.flax_key("codecs.0.transform.stages_0.bogus")

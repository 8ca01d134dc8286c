"""Training/eval runtime: the agent that owns model, optimizer, data,
controllers and checkpoints.

Mode dispatch follows the JAX package's ``train/loop.py``: train /
train_postprocess / validate / validate_recu_reco / test / debug (debug
wraps training in ``torch.autograd.detect_anomaly``). Any exception
triggers a checkpoint save before it is raised again.

The device is explicit: CUDA unless the caller passes ``device="cpu"``.
``test`` codes every test image into a real bitstream and back
(``coding/codec_coder.py``: the transforms on the device, the entropy
coding in host C++), in tiles (``coding/tiled_coder.py``) where
``tile_size`` divides the image's height into more than one.
``train_postprocess`` trains the restoration net on the frozen codec
(``train/postprocess_loop.py``). With ``mesh_shape`` of more than one
device the agent is one rank of a data-parallel run (the CLI starts the
ranks): it trains with ``parallel/dp.py``'s ``make_shardmap_train_step``
and evaluates with ``make_dp_eval_step``, or with ``parallel/tiling.py``'s
``make_halo_eval_step`` under ``halo_eval``; rank 0 alone logs, saves the
checkpoints (plain state dicts, so a mesh run and a single-device run
resume from each other) and runs ``test``.
``steps_per_call`` is accepted and ignored: it chains steps to hide a
TPU's dispatch latency, and every step here is dispatched on its own.
fp32 runs at full fp32 precision (``config.full_fp32``: TF32 off).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..config import Config, full_fp32, resolve_device
from ..models.codec import CodecWrapper
from ..utils.heartbeat import Heartbeat
from ..utils.profiling import DeviceTrace, PhaseTimers
from . import checkpoint as ckpt
from .data import ImageDataLoader
from .loggers import RDLogger, setup_logging
from .state import (LossSwitchController, PlateauScheduler, make_eval_step,
                    make_optimizer, make_train_step)


def _to_nchw(batch: np.ndarray) -> torch.Tensor:
    """The loader's NHWC float32 batch as an NCHW tensor (a view)."""
    return torch.from_numpy(batch).permute(0, 3, 1, 2)


class LiftingDWTAgent:
    """End-to-end experiment runtime for the wavelet codec family."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        full_fp32()
        self.mesh = self._build_mesh(device)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.device = (resolve_device(device) if self.mesh is None
                       else self.mesh.device)
        if self.is_main:
            self.logger = setup_logging(cfg.log_dir)
        else:
            self.logger = logging.getLogger(f"lwc_torch.rank{self.mesh.rank}")
            self.logger.setLevel(logging.WARNING)
        if self.mesh is not None:
            self.logger.info(
                f"data-parallel mesh: {self.mesh.size} ranks "
                f"({cfg.batch_size // self.mesh.size} examples/rank, "
                f"{self.mesh.backend} on {self.mesh.device})")
        if cfg.steps_per_call > 1:
            self.logger.info(
                f"steps_per_call={cfg.steps_per_call} is ignored: every step "
                "is dispatched on its own")
        if cfg.imshow_validation:
            self.logger.info("imshow_validation is ignored: the pyramid plots "
                             "are not ported yet (ROADMAP Queue A item 14)")
        # liveness beacon (a no-op unless LIFTING_HEARTBEAT is set)
        self.heartbeat = Heartbeat()
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = CodecWrapper(cfg, generator=init_gen).to(self.device)
        self.data = ImageDataLoader(cfg)
        self.optimizer = make_optimizer(cfg, self.model)
        if self.mesh is None:
            self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                              self.device)
            self.eval_step = make_eval_step(cfg, self.model, self.device)
            # quantization noise, drawn on the device the model runs on
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(cfg.seed + 7)
        else:
            from ..parallel import dp
            self.train_step, shard_state = dp.make_shardmap_train_step(
                cfg, self.model, self.optimizer, self.mesh)
            shard_state()
            if cfg.halo_eval:
                from ..parallel.tiling import make_halo_eval_step
                self.eval_step = make_halo_eval_step(cfg, self.model,
                                                     self.mesh)
            else:
                self.eval_step = dp.make_dp_eval_step(cfg, self.model,
                                                      self.mesh)
            # each rank's own noise, seeded from (seed, rank)
            self.generator = dp.rank_generator(cfg.seed + 7, self.mesh)

        self.scheduler = PlateauScheduler(lr=cfg.learning_rate)
        self.loss_switch = LossSwitchController(
            enabled=(cfg.training_loss_switch == 0),
            threshold=cfg.loss_switch_thr)
        self.current_epoch = 0
        self.current_iteration = 0
        self.best_valid_loss = float("inf")
        self.timers = PhaseTimers()
        self._trace = None

        jsonl = (f"{cfg.summary_dir}/metrics.jsonl"
                 if cfg.summary_dir and self.is_main else None)
        self.train_logger = RDLogger(self.logger, jsonl)
        self.trnit_logger = RDLogger(self.logger, jsonl)
        self.valid_logger = RDLogger(self.logger, jsonl)
        self.test_logger = RDLogger(self.logger, jsonl)
        self.last_test_per_image = []

        if cfg.mode in ("test", "validate", "validate_recu_reco"):
            self.load_checkpoint("model_best")
        elif cfg.resume_training:
            self.load_checkpoint(cfg.checkpoint_file)
        self.model_size_estimation()

    def _build_mesh(self, device):
        """The data-parallel mesh of ``cfg.mesh_shape`` (this process is one
        of its ranks; the CLI starts them and joins the process group), or
        None for one device."""
        n = int(np.prod(self.cfg.mesh_shape))
        if n <= 1:
            return None
        if self.cfg.batch_size % n:
            raise ValueError(f"batch_size {self.cfg.batch_size} not "
                             f"divisible by mesh size {n}")
        from ..parallel import mesh as mesh_lib
        return mesh_lib.make_mesh(n, device=device)

    # ------------------------------------------------------------------
    def run(self):
        mode = self.cfg.mode
        if mode == "test" and not self.is_main:
            return  # rank 0 codes the test images
        try:
            if mode == "train":
                self.train()
            elif mode == "debug":
                with torch.autograd.detect_anomaly():
                    self.train()
            elif mode == "validate":
                self.validate()
            elif mode == "validate_recu_reco":
                self.validate_recu_reco()
            elif mode == "test":
                self.test()
            elif mode == "train_postprocess":
                self.train_postprocess()
            else:
                raise ValueError(f"unknown mode {mode!r}")
        except KeyboardInterrupt:
            self.logger.info("interrupted: saving checkpoint")
            self.save_checkpoint()
        except Exception:
            self.logger.exception("run crashed: saving checkpoint")
            self.save_checkpoint()
            raise

    def train(self):
        cfg = self.cfg
        for epoch in range(self.current_epoch, cfg.max_epoch):
            self.current_epoch = epoch
            self.train_one_epoch(epoch)
            if (epoch + 1) % cfg.validate_every == 0:
                valid_loss = self.validate()
                is_best = valid_loss < self.best_valid_loss
                self.best_valid_loss = min(valid_loss, self.best_valid_loss)
                self.save_checkpoint(is_best=is_best)
            elif cfg.save_every_epochs > 0 \
                    and (epoch + 1) % cfg.save_every_epochs == 0:
                # crash insurance between (or instead of) validations
                self.save_checkpoint()

    def _profile_tick(self):
        """Device-trace window: steps [1, 1+profile_steps) of the run (step
        0 pays the kernel build and cuDNN's planning); rank 0's alone."""
        cfg = self.cfg
        if cfg.profile_steps <= 0 or not self.is_main:
            return
        if self._trace is None and self.current_iteration == 1:
            self._trace = DeviceTrace(
                os.path.join(cfg.log_dir or ".", "trace"), self.device)
            self._trace.start()
            self.logger.info("profiler trace started")
        elif self._trace is not None and (self.current_iteration
                                          >= 1 + cfg.profile_steps):
            self._stop_trace()

    def _stop_trace(self):
        path = self._trace.stop()
        self._trace = None
        self.logger.info(f"profiler trace stopped -> {path}")

    def train_one_epoch(self, epoch: int):
        cfg = self.cfg
        steps = self.data.steps_per_epoch()
        batches = iter(self.data.train_batches(steps, seed=epoch))
        while True:
            with self.timers.phase("data"):
                batch = next(batches, None)
            if batch is None:
                break
            self._profile_tick()
            with self.timers.phase("step"):
                out, _ = self.train_step(
                    _to_nchw(batch), self.generator, self.scheduler.lr,
                    self.loss_switch.rate_weight())
                # the readback is the device sync point: the step's time
                # holds the device work, not only the enqueue
                vals = tuple(float(v) for v in out)
            self.heartbeat.beat()
            self.current_iteration += 1
            self.train_logger(*vals)
            self.trnit_logger(*vals)
            if self.current_iteration % cfg.loss_prnt_iters == 0:
                _, it_mse, _, _ = self.trnit_logger.display(
                    lr=self.scheduler.lr, typ="it",
                    step=self.current_iteration)
                was_off = not self.loss_switch.rate_on
                self.loss_switch.observe_window_mse(it_mse)
                if was_off and self.loss_switch.rate_on:
                    self.logger.info(
                        "loss switch: D-only -> Rate + lambda*Distortion")
        rd, _, _, _ = self.train_logger.display(
            lr=self.scheduler.lr, typ="tr", step=self.current_iteration)
        self.scheduler.step(rd)
        if self._trace is not None:  # epoch shorter than the asked window
            self._stop_trace()
        if cfg.phase_timers:
            self.logger.info("phase timers:\n" + self.timers.report())

    def validate(self) -> float:
        psnrs, r1s, r2s = [], [], []
        for batch in self.data.valid_batches():
            out, _ = self.eval_step(_to_nchw(batch))
            self.heartbeat.beat()
            loss, mse, rate1, rate2 = (float(v) for v in out)
            self.valid_logger(loss, mse, rate1, rate2)
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            r1s.append(rate1)
            r2s.append(rate2)
        rd, _, _, _ = self.valid_logger.display(
            lr=0.0, typ="va", step=self.current_iteration)
        self.logger.info(
            f" avg_psnr = {np.mean(psnrs):.2f}, rate_1 = {np.mean(r1s):.4f},"
            f" rate_2 = {np.mean(r2s):.4f},"
            f" total_rate = {np.mean(r1s) + np.mean(r2s):.4f}")
        return rd

    def validate_recu_reco(self):
        """Recursive-reconstruction validation: a stub in the original and
        in the JAX package too."""
        self.logger.info("validate_recu_reco: not implemented (stub parity)")

    def test(self):
        """Real encode and decode of every test image, one at a time, with
        the bitstream path; logs each image and the means. Returns
        ``(mean PSNR, mean bpp)``. Where ``tile_size`` divides an image's
        height into more than one tile, the image is coded in tiles
        (``coding/tiled_coder.py``), as the JAX package's agent does."""
        from ..coding.codec_coder import CodecCoder

        cfg = self.cfg
        coder = CodecCoder(cfg, self.model, self.device)
        tiled = {}

        def code(img: np.ndarray):
            h = img.shape[1]
            if cfg.tile_size and h > cfg.tile_size \
                    and h % cfg.tile_size == 0:
                n = h // cfg.tile_size
                if n not in tiled:
                    from ..coding.tiled_coder import TiledCodecCoder
                    tiled[n] = TiledCodecCoder(cfg, self.model, n,
                                               device=self.device)
                return tiled[n].compress_decompress(img)
            return coder.compress_decompress(img)

        psnrs, bpps = [], []
        for batch in self.data.test_batches():
            res = code(np.asarray(batch))
            self.heartbeat.beat()
            psnrs.append(res.psnr)
            bpps.append(res.bpp)
            self.test_logger(0.0, 10 ** (-res.psnr / 10), res.bpp, 0.0)
            self.logger.info(f" test image {len(psnrs) - 1}: "
                             f"psnr = {res.psnr:.3f}, bpp = {res.bpp:.5f}")
        # per-image operating points: the spread is part of the result
        self.last_test_per_image = [
            {"psnr": round(float(p), 3), "bpp": round(float(b), 5)}
            for p, b in zip(psnrs, bpps)]
        self.logger.info(
            f" avg_psnr = {np.mean(psnrs):.2f} (std {np.std(psnrs):.2f}), "
            f"total_rate = {np.mean(bpps):.4f} bpp "
            f"(std {np.std(bpps):.4f}, real bitstream)")
        return float(np.mean(psnrs)), float(np.mean(bpps))

    def train_postprocess(self):
        """Train ``cfg.postprocess``'s restoration net on the frozen codec
        (``train/postprocess_loop.py``); the net is left in
        ``self.pp_model``, outside the checkpoint."""
        from .postprocess_loop import train_postprocess
        return train_postprocess(self)

    # ------------------------------------------------------------------
    def save_checkpoint(self, is_best: bool = False):
        if not self.cfg.checkpoint_dir or not self.is_main:
            return
        payload = {
            "epoch": self.current_epoch,
            "iteration": self.current_iteration,
            "best_valid_loss": self.best_valid_loss,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "loss_switch": self.loss_switch.state_dict(),
            "train_logger": self.train_logger.state_dict(),
            "valid_logger": self.valid_logger.state_dict(),
        }
        ckpt.save_checkpoint(self.cfg.checkpoint_dir, payload, is_best,
                             name=self.cfg.checkpoint_file)
        self.heartbeat.beat(force=True)

    def load_checkpoint(self, name: str):
        def load(n):
            return ckpt.load_checkpoint(self.cfg.checkpoint_dir, n,
                                        map_location=self.device)

        payload = load(name)
        if payload is None and name != "model_best":
            # the rolling checkpoint may be missing; model_best is written
            # atomically too and is the best surviving state
            self.logger.warning(
                f"no checkpoint {name!r}: falling back to 'model_best'")
            name = "model_best"
            payload = load(name)
        if payload is None:
            self.logger.warning(f"no checkpoint {name!r} found: fresh init")
            return
        self.current_epoch = int(payload["epoch"])
        self.current_iteration = int(payload["iteration"])
        self.best_valid_loss = float(payload["best_valid_loss"])
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        self.loss_switch.load_state_dict(payload["loss_switch"])
        self.train_logger.load_state_dict(payload["train_logger"])
        self.valid_logger.load_state_dict(payload["valid_logger"])
        self.logger.info(f"restored checkpoint {name!r} at epoch "
                         f"{self.current_epoch}")

    def finalize(self):
        self.save_checkpoint()

    def model_size_estimation(self):
        n_params = sum(p.numel() for p in self.model.parameters())
        mb = n_params * 4 / 1024 ** 2
        self.logger.info(f"model params: {n_params:,} ({mb:.2f} MB fp32)")
        return mb

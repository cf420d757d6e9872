"""CLI driver: train a collaborative-filtering model from a YAML config.

The counterpart of the reference driver (cf/main.py:19-124):

    python -m heat_cf.main --config benchmarks/Gowalla/config0.yaml

Differences from the reference flow:
* no MPI scatter of pickled datasets — in a multi-host run every host parses
  the files and slices its own deterministic user range
  (``shard_by_user_range``) based on ``jax.process_index()``;
* evaluation runs the tiled on-device evaluator and the full configured
  metric list (the reference driver hardcodes Recall(k=20) at main.py:120
  despite the config's richer metrics list);
* ``--synthetic`` trains on a generated planted-cluster dataset when the
  benchmark text files are not available.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from heat_cf.config import load_config, parse_scalar
from heat_cf.data.datasets import load_with_cache, shard_by_user_range
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.train.engine import Engine


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--config", type=str, required=True, help="YAML config path"
    )
    parser.add_argument(
        "--synthetic",
        type=str,
        default=None,
        metavar="U,I",
        help="train on a synthetic UxI planted-cluster dataset instead of files",
    )
    parser.add_argument(
        "--epochs", type=int, default=None, help="override config epochs"
    )
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument(
        "--log-file",
        type=str,
        default=None,
        help="append JSONL training/eval events (loss, lr, epoch time, metrics)",
    )
    parser.add_argument(
        "--profile-dir",
        type=str,
        default=None,
        help="capture a jax.profiler device trace of epoch 0 into this dir "
        "(view with tensorboard or xprof)",
    )
    parser.add_argument(
        "--export-embeddings",
        type=str,
        default=None,
        metavar="PATH.npz",
        help="after training, export the tables (+ w0) as portable "
        "float32 numpy arrays (one compressed .npz, no JAX needed to load)",
    )
    parser.add_argument(
        "--breakdown",
        action="store_true",
        help="print the host-phase performance breakdown at the end "
        "(the reference Engine::performance_breakdown)",
    )
    parser.add_argument(
        "--no-data-cache",
        action="store_true",
        help="disable the .npz sidecar cache of parsed click files",
    )
    parser.add_argument(
        "--fused-epochs",
        type=int,
        default=1,
        metavar="N",
        help="run up to N epochs per device program (Engine.train_epochs): "
        "one dispatch + one on-device scan instead of N; eval cadence is "
        "kept. "
        "Per-epoch wall times become chunk averages and checkpoints are "
        "written once per chunk.",
    )
    parser.add_argument(
        "--fused-run",
        action="store_true",
        help="run the ENTIRE schedule — every epoch scan and every "
        "periodic evaluation — as one device program "
        "(Engine.run_epochs_with_eval; falls back to the normal loop for "
        "multi-host/sub-epoch/fixed-stream configs; DESIGN.md 6e). "
        "Incompatible with --profile-dir; checkpoints are written once at "
        "the end.",
    )
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override a model_config key (value parsed like a config "
        "scalar or flow list; repeatable), "
        "e.g. --set optimizer=adam --set learning_rate=0.005",
    )
    args = parser.parse_args(argv)

    overrides = {}
    for item in args.overrides:
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        overrides[key] = parse_scalar(value)
    cfg, ds_cfg = load_config(args.config, **overrides)
    if args.epochs is not None:
        cfg.epochs = args.epochs

    import jax

    # Persistent XLA compilation cache: repeat CLI runs skip re-compiling
    # the epoch/eval programs (utils/cache.py;
    # HEAT_CF_NO_COMPILATION_CACHE=1 disables).
    from heat_cf.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    if args.synthetic:
        num_users, num_items = (int(x) for x in args.synthetic.split(","))
        train_data, test_data = synthetic_click_dataset(
            num_users=num_users,
            num_items=num_items,
            max_his=cfg.max_his,
            seed=cfg.seed,
        )
    else:
        train_path = os.path.join(ds_cfg.data_dir, ds_cfg.train_data)
        test_path = os.path.join(ds_cfg.data_dir, ds_cfg.test_data)
        if not os.path.exists(train_path):
            raise SystemExit(
                f"training data not found: {train_path}\n"
                "Point dataset_config.data_dir at a LightGCN-format dataset "
                "(user item1 item2 ... lines), or pass --synthetic U,I to "
                "train on generated data."
            )
        train_data = load_with_cache(
            train_path, max_his=cfg.max_his, separator=ds_cfg.separator,
            seed=cfg.seed, cache=not args.no_data_cache,
        )
        test_data = load_with_cache(
            test_path,
            max_his=cfg.max_his,
            separator=ds_cfg.separator,
            num_items=train_data.num_items,
            seed=cfg.seed,
            cache=not args.no_data_cache,
        )
        nproc = jax.process_count()
        if nproc > 1:
            rank = jax.process_index()
            # Global ids: the shards feed one global row-sharded user table.
            train_data = shard_by_user_range(
                train_data, nproc, rank, rebase=False
            )
            test_data = shard_by_user_range(test_data, nproc, rank)

    mesh = None
    if jax.process_count() > 1 or len(jax.devices()) > 1:
        from heat_cf.parallel.distributed import global_mesh

        mesh = global_mesh()
    engine = Engine(cfg, train_data, test_data, mesh=mesh)
    if args.checkpoint_dir:
        from heat_cf.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        restored = ckpt.restore_latest(engine)
        if restored is not None:
            print(f"resumed from epoch {engine.epoch}")
    else:
        ckpt = None

    from heat_cf.utils.logging import MetricsLogger

    mlog = MetricsLogger(args.log_file)
    # Trace the second epoch of this run so epoch one absorbs compilation
    # (falls back to the first — compile included — for single-epoch runs).
    profile_epoch = None
    if args.profile_dir:
        profile_epoch = min(engine.epoch + 1, cfg.epochs - 1)
    if args.fused_run:
        if args.profile_dir:
            parser.error("--fused-run is incompatible with --profile-dir")
        t0 = time.time()
        start_epoch = engine.epoch
        losses, evals = engine.run_epochs_with_eval(
            cfg.epochs - start_epoch, cfg.eval_interval
        )
        dt = (time.time() - t0) / max(1, len(losses))
        pending = list(evals)
        for i, loss in enumerate(losses):
            epoch = start_epoch + i
            print(
                f"epoch: {epoch}; loss: {loss:.6f}; epoch_time: {dt:.3f}s"
            )
            mlog.log(
                "epoch",
                epoch=epoch,
                loss=loss,
                lr=float(engine.state.lr),
                epoch_time_s=dt,
            )
            while pending and pending[0]["epoch"] == epoch:
                ev = pending.pop(0)
                metrics = {k: v for k, v in ev.items() if k != "epoch"}
                print(
                    "[Metrics] "
                    + " - ".join(
                        f"{k}: {v:.6f}" for k, v in metrics.items()
                    )
                )
                mlog.log("eval", epoch=epoch, **metrics)
        if ckpt is not None:
            ckpt.save(engine)
    fused = max(1, args.fused_epochs)
    while engine.epoch < cfg.epochs:
        start = engine.epoch
        # Chunk size: bounded by the fused-epochs setting, the end of
        # training, the next eval boundary, and the traced epoch (which
        # must run alone so the trace captures exactly one epoch).
        n = min(fused, cfg.epochs - start)
        # Next epoch index whose completion triggers an eval (the reference
        # evaluates after finishing epoch e when e % eval_interval == 0,
        # e > 0, main.py:115-124); the chunk may run through it but not past.
        next_eval = -(-max(start, 1) // cfg.eval_interval) * cfg.eval_interval
        n = min(n, next_eval - start + 1)
        if profile_epoch is not None and start <= profile_epoch < start + n:
            n = 1 if start == profile_epoch else profile_epoch - start
        t0 = time.time()
        if n == 1 and start == profile_epoch:
            from heat_cf.utils.profiling import trace

            with trace(args.profile_dir):
                losses = [engine.train_one_epoch()]
        elif n == 1:
            losses = [engine.train_one_epoch()]
        else:
            losses = engine.train_epochs(n)
        dt = (time.time() - t0) / n
        for i, loss in enumerate(losses):
            epoch = start + i
            print(
                f"epoch: {epoch}; loss: {loss:.6f}; epoch_time: {dt:.3f}s"
            )
            mlog.log(
                "epoch",
                epoch=epoch,
                loss=loss,
                lr=float(engine.state.lr),
                epoch_time_s=dt,
            )
        if ckpt is not None:
            ckpt.save(engine)
        epoch = engine.epoch - 1  # last completed epoch
        if epoch > 0 and epoch % cfg.eval_interval == 0:
            metrics = engine.evaluate()
            print(
                "[Metrics] "
                + " - ".join(f"{k}: {v:.6f}" for k, v in metrics.items())
            )
            mlog.log("eval", epoch=epoch, **metrics)

    metrics = engine.evaluate()
    mlog.log("final_eval", epoch=cfg.epochs, **metrics)
    mlog.close()
    if args.export_embeddings:
        # All processes participate (gathering a sharded table is a
        # collective); each host writes its own local copy.
        from heat_cf.export import export_embeddings

        export_embeddings(
            engine.unpadded_state(), args.export_embeddings, cfg=cfg
        )
        if jax.process_index() == 0:
            print(f"exported embeddings to {args.export_embeddings}")
    if args.breakdown:
        print(engine.performance_breakdown())
    print(json.dumps({"final_metrics": metrics}))


if __name__ == "__main__":
    main()

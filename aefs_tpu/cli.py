"""Offline CLI: process a WAV through an effect chain on the device.

The "minimum end-to-end slice" surface (SURVEY.md §7): decode a WAV, build
a chain from a preset name or a JSON config file, scan it on-device, write
the result.

    python -m aefs_tpu.cli input.wav output.wav --preset "Rain Delay"
    python -m aefs_tpu.cli input.wav output.wav --config chain.json
    python -m aefs_tpu.cli --batch out_dir/ a.wav b.wav c.wav --preset Octave
    python -m aefs_tpu.cli --list-presets
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="INPUT OUTPUT (single-file mode) or INPUT... "
                         "(with --batch OUT_DIR)")
    ap.add_argument("--batch", metavar="OUT_DIR",
                    help="bulk mode: render every input WAV through the "
                         "chain in ONE batched device dispatch (vmapped "
                         "whole-file fast path); outputs land in OUT_DIR")
    ap.add_argument("--shard", action="store_true",
                    help="with --batch: distribute the batch over all "
                         "visible devices (data-parallel rendering)")
    ap.add_argument("--preset", help="factory preset name")
    ap.add_argument("--config", help="JSON chain-config file")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--platform", choices=("cpu", "gpu"), default=None,
                    help="run on this JAX platform (default: JAX's choice); "
                         "a missing one is an error")
    ap.add_argument("--checkpoint", metavar="DIR",
                    help="process resumably in chunks, checkpointing chain "
                         "state + partial output to DIR (long file jobs)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed job from --checkpoint DIR "
                         "(bit-exact: ring buffers/filter taps/phasors resume)")
    ap.add_argument("--checkpoint-every", type=float, default=10.0,
                    metavar="SECONDS", help="checkpoint interval in audio "
                    "seconds (default 10)")
    args = ap.parse_args(argv)

    from aefs_tpu.core.config import DEFAULT_PRESETS

    if args.list_presets:
        for name, chain in DEFAULT_PRESETS.items():
            kinds = " -> ".join(c["type"] for c in chain)
            print(f"{name}: {kinds}")
        return 0

    if args.batch:
        if not args.paths:
            ap.error("--batch requires at least one input WAV")
    elif len(args.paths) != 2:
        ap.error("single-file mode takes INPUT OUTPUT "
                 "(or use --batch / --list-presets)")

    from aefs_tpu.utils.platform import enable_compile_cache, select_platform

    backend = select_platform(args.platform)
    enable_compile_cache()

    if args.config:
        with open(args.config) as f:
            chain_config = json.load(f)
    elif args.preset:
        if args.preset not in DEFAULT_PRESETS:
            ap.error(f"unknown preset {args.preset!r}; see --list-presets")
        chain_config = DEFAULT_PRESETS[args.preset]
    else:
        chain_config = []

    from aefs_tpu.engine.engine import process_offline, render_batch
    from aefs_tpu.engine.wavio import read_wav_file, write_wav_file

    if args.batch:
        import os

        audios, fss = [], []
        for p in args.paths:
            a, f = read_wav_file(p)
            audios.append(a)
            fss.append(f)
        if len(set(fss)) != 1:
            ap.error(f"--batch needs one sample rate, got {sorted(set(fss))}")
        fs = fss[0]
        total_s = sum(a.shape[0] for a in audios) / fs
        print(f"{len(audios)} files, {total_s:.2f} s total @ {fs} Hz "
              f"(backend: {backend})")
        t0 = time.time()
        outs = render_batch(chain_config, audios, fs, shard=args.shard)
        dt = time.time() - t0
        os.makedirs(args.batch, exist_ok=True)
        # De-collide output names: inputs from different directories may
        # share a basename and must not overwrite each other.
        seen = {}
        for p, out in zip(args.paths, outs):
            base = os.path.basename(p)
            n = seen.get(base, 0)
            seen[base] = n + 1
            if n:
                stem, ext = os.path.splitext(base)
                base = f"{stem}.{n}{ext}"
            write_wav_file(os.path.join(args.batch, base), out, fs)
        print(f"{args.batch}: {len(outs)} files in {dt*1000:.1f} ms "
              f"({total_s/dt:.0f}x realtime aggregate, one dispatch)")
        return 0

    in_path, out_path = args.paths
    audio, fs = read_wav_file(in_path)
    print(f"{in_path}: {audio.shape[0]/fs:.2f} s @ {fs} Hz, "
          f"{audio.shape[1] if audio.ndim > 1 else 1} ch (backend: {backend})")

    t0 = time.time()
    if args.checkpoint:
        out = process_resumable(
            chain_config, audio, fs, args.checkpoint,
            resume=args.resume, every_s=args.checkpoint_every,
        )
    else:
        _, out = process_offline(chain_config, audio, fs)
    dt = time.time() - t0
    write_wav_file(out_path, out, fs)
    rtf = (audio.shape[0] / fs) / dt
    print(f"{out_path}: processed in {dt*1000:.1f} ms ({rtf:.0f}x realtime)")
    return 0


def process_resumable(chain_config, audio, fs, ckpt_dir, resume=False,
                      every_s=10.0):
    """Chunked blockwise processing with periodic session checkpoints: a
    killed job restarted with --resume continues bit-exact from the last
    checkpoint (the carried state pytree holds every ring buffer, filter
    tap and phasor — engine/checkpoint.py)."""
    import os
    import shutil

    import numpy as np

    from aefs_tpu.core.chain import build_chain
    from aefs_tpu.core.config import FILE_SUPERBLOCK
    from aefs_tpu.core.fileopts import file_static_overrides
    from aefs_tpu.engine.checkpoint import load_session, save_session

    if audio.ndim > 1:
        mono = audio.mean(axis=1, keepdims=True).astype(np.float32)
    else:
        mono = audio.reshape(-1, 1).astype(np.float32)
    n = mono.shape[0]
    # Chunks must stay blocksize-aligned so the carried state is identical
    # to an uninterrupted blockwise run (bit-exact resume).
    chunk = max(FILE_SUPERBLOCK,
                int(every_s * fs) // FILE_SUPERBLOCK * FILE_SUPERBLOCK)

    done = 0
    outs = []
    irs, profiles = {}, {}
    progress_path = os.path.join(ckpt_dir, "progress.json")
    chunks_dir = os.path.join(ckpt_dir, "chunks")
    resuming = resume and os.path.exists(progress_path)
    if resuming:
        with open(progress_path) as f:
            progress = json.load(f)
        # Refuse a checkpoint written for a DIFFERENT input: done_samples
        # applied to another file would splice two inputs' audio (or emit
        # a stale partial untouched) with no error.
        if (int(progress.get("n_samples", n)) != n
                or int(progress.get("fs", fs)) != fs):
            raise SystemExit(
                f"--resume: checkpoint was written for a different input "
                f"({progress.get('n_samples')} samples @ "
                f"{progress.get('fs')} Hz; this file is {n} @ {fs})")
        done = int(progress["done_samples"])
        # ``dir`` names the committed generation subdir (see the commit
        # protocol below); legacy checkpoints kept everything flat.
        gen_dir = os.path.join(ckpt_dir, progress["dir"]) if "dir" in progress \
            else ckpt_dir
        (cfg2, tmap2, rebuild_state, irs, profiles,
         ck_meta) = load_session(gen_dir)
        overrides = file_static_overrides(cfg2)
        if irs:  # a server-written checkpoint may carry uploaded IRs
            from aefs_tpu.engine.checkpoint import ir_static_overrides

            for eid, ov in ir_static_overrides(irs, cfg2, fs).items():
                overrides.setdefault(eid, {}).update(ov)
        if profiles:  # ... and learned spectral noise profiles
            from aefs_tpu.engine.checkpoint import (
                profile_static_overrides, remap_profiles)

            # fs-dependent bins: re-bin profiles saved at another rate
            profiles = remap_profiles(profiles, ck_meta.get("fs"), fs)
            for eid, ov in profile_static_overrides(profiles, cfg2).items():
                overrides.setdefault(eid, {}).update(ov)
        chain, state, _ = build_chain(
            cfg2, fs, FILE_SUPERBLOCK, channels_in=1, channels_out=2,
            static_overrides=overrides,
        )
        targets = chain.targets(tmap2)
        state = rebuild_state(chain.init_state())
        chain_config, tmap = cfg2, tmap2
        outs = _load_partial_chunks(chunks_dir, gen_dir, done)
        print(f"Resuming at {done / fs:.2f} s / {n / fs:.2f} s")
    else:
        # File-mode statics (min_delay from the configured delay etc.)
        # keep the blockwise solvers' static iteration counts small at
        # superblock size.  Built only when NOT resuming — the resume
        # branch rebuilds from the checkpoint's own config.
        chain, state, tmap = build_chain(
            chain_config, fs, FILE_SUPERBLOCK, channels_in=1, channels_out=2,
            static_overrides=file_static_overrides(chain_config),
        )
        targets = chain.targets(tmap)
        # A fresh job must not inherit another job's persisted chunks: a
        # later resume could otherwise splice a stale longer chunk from
        # the previous lineage at the same start offset.
        if os.path.isdir(chunks_dir):
            shutil.rmtree(chunks_dir, ignore_errors=True)

    while done < n:
        start, end = done, min(done + chunk, n)
        state, y = chain.process_array(state, targets, mono[start:end],
                                       fast=False)
        outs.append(np.clip(y, -1.0, 1.0))
        done = end
        if done < n:
            # Crash-safe commit: persist THIS chunk's output (O(chunk)
            # per checkpoint — the old whole-prefix partial.npy rewrite
            # made checkpoint I/O quadratic in file length), stage state
            # in a fresh generation subdir, then atomically swap
            # progress.json (the single manifest) to point at it.  A
            # kill at any instant — including mid-save — leaves the
            # previous generation intact and referenced, so resume never
            # double-processes a chunk (the old flat layout had windows
            # where a new state.npz sat next to an old done_samples).
            os.makedirs(chunks_dir, exist_ok=True)
            cpath = os.path.join(chunks_dir, f"chunk-{start}-{done}.npy")
            with open(cpath + ".tmp", "wb") as f:
                np.save(f, outs[-1])
                f.flush()
                os.fsync(f.fileno())
            os.replace(cpath + ".tmp", cpath)
            gen_dir = os.path.join(ckpt_dir, f"gen-{done}")
            # IRs/profiles the resumed session carried must ride EVERY
            # re-checkpoint, or the second resume rebuilds on the
            # synthetic IR (leaf-shape failure) / silently drops the
            # learned noise floor.
            save_session(gen_dir, chain_config,
                         {k: dict(v) for k, v in tmap.items()}, state,
                         custom_irs=irs, noise_profiles=profiles, fs=fs)
            tmp = progress_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"done_samples": int(done),
                           "n_samples": int(n), "fs": int(fs),
                           "dir": f"gen-{done}"}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, progress_path)  # the commit point
            for name in os.listdir(ckpt_dir):  # prune superseded gens
                if name.startswith("gen-") and name != f"gen-{done}":
                    shutil.rmtree(os.path.join(ckpt_dir, name),
                                  ignore_errors=True)
            print(f"Checkpointed at {done / fs:.2f} s / {n / fs:.2f} s")
    return np.concatenate(outs)


def _load_partial_chunks(chunks_dir, gen_dir, done):
    """Load the persisted output covering samples [0, done): per-chunk
    files written once each (chunk-{start}-{end}.npy), walked greedily by
    coverage (overlapping grids from an interval change pick the longest
    committed chunk — within one job lineage any committed chunk's
    content over a range is identical).  Falls back to the legacy
    whole-prefix ``partial.npy`` inside the generation dir."""
    import os

    import numpy as np

    if done <= 0:
        return []
    by_start = {}
    if os.path.isdir(chunks_dir):
        import re

        for name in os.listdir(chunks_dir):
            m = re.match(r"chunk-(\d+)-(\d+)\.npy$", name)
            if not m:
                continue
            s, e = int(m.group(1)), int(m.group(2))
            if e <= done and e > s and e > by_start.get(s, (0, None))[0]:
                by_start[s] = (e, name)
    if by_start:
        outs, cov = [], 0
        while cov < done:
            if cov not in by_start:
                raise SystemExit(
                    f"--resume: checkpoint chunks cover only [0, {cov}) of "
                    f"the committed {done} samples (missing chunk at {cov})")
            e, name = by_start[cov]
            outs.append(np.load(os.path.join(chunks_dir, name)))
            cov = e
        return outs
    legacy = os.path.join(gen_dir, "partial.npy")
    if os.path.exists(legacy):
        return [np.load(legacy)]
    raise SystemExit(
        "--resume: no persisted output found (chunks/ empty and no legacy "
        "partial.npy) — the checkpoint directory is incomplete")


if __name__ == "__main__":
    sys.exit(main())

"""Corpus-scale CLI: encode, decode or transcode whole directories with
the batch drivers (resume, per-file error isolation), on the card by
default.

Usage:
  python -m torchdraco.tools.corpus encode    -i meshes/ -o out/ [--route auto]
  python -m torchdraco.tools.corpus decode    -i drcs/   -o out/ [--fmt ply]
  python -m torchdraco.tools.corpus transcode -i glbs/   -o out/

Every command runs its device plane on the card unless told otherwise:
``--device cpu`` runs the same plane with the kernels' plain twins on the
CPU, ``--host-only`` takes the host plane. Without a card and without
either flag the command exits non-zero. Inputs may be directories
(scanned non-recursively for known extensions) or explicit file lists.

Under a launcher that sets ``WORLD_SIZE`` above 1 (torchrun, or
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` by hand), ``encode`` runs as one process of a group
(``torchdraco.parallel.multihost``): each encodes its slice of the
corpus on its local rank's card and prints the totals of all.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ENCODE_EXTS = (".obj", ".ply", ".gltf", ".glb")
DECODE_EXTS = (".drc",)
TRANSCODE_EXTS = (".gltf", ".glb")


def _expand(inputs: list[str], exts) -> list[str]:
    out = []
    for p in inputs:
        if os.path.isdir(p):
            for e in exts:
                out.extend(sorted(glob.glob(os.path.join(p, "*" + e))))
        else:
            out.append(p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torchdraco-corpus")
    ap.add_argument("command", choices=("encode", "decode", "transcode"))
    ap.add_argument("-i", "--input", nargs="+", required=True,
                    help="input files or directories")
    ap.add_argument("-o", "--output", required=True, help="output directory")
    ap.add_argument("--device", nargs="?", const="cuda", default=None,
                    choices=("cuda", "cpu"),
                    help="where the device plane runs: the card (the "
                         "default; '--device' alone or '--device cuda') or "
                         "'cpu' (the kernels' plain twins)")
    ap.add_argument("--route", choices=("manual", "auto"), default="manual",
                    help="encode: 'auto' measures the host and device "
                         "planes per topology group in-process and routes "
                         "each group to the faster one (decisions in the "
                         "corpus report)")
    ap.add_argument("--host-only", action="store_true",
                    help="every command: the host plane, no device")
    ap.add_argument("--no-resume", action="store_true",
                    help="re-process inputs whose outputs already exist")
    ap.add_argument("--workers", type=int, default=1,
                    help="host thread workers (encode/decode)")
    ap.add_argument("--window", type=int, default=None,
                    help="encode: meshes loaded at once on the device "
                         "planes (bounded host RAM; default 1024)")
    ap.add_argument("--fmt", default="obj", choices=("obj", "ply"),
                    help="decode output format")
    ap.add_argument("--khr-ids", choices=("unique", "reference"),
                    default="unique",
                    help="transcode: KHR attribute-id mapping (see the "
                         "single-file CLI)")
    ap.add_argument("-cl", "--compression-level", type=int, default=None,
                    choices=range(0, 11), metavar="N",
                    help="transcode: compression preset for every "
                         "primitive (routes primitives to the host "
                         "encoder; -qp/-qt/-qn alone stay on device)")
    ap.add_argument("-qp", type=int, default=None, metavar="BITS",
                    help="position quantization bits (encode + transcode)")
    ap.add_argument("-qt", type=int, default=None, metavar="BITS",
                    help="texcoord quantization bits (encode + transcode)")
    ap.add_argument("-qn", type=int, default=None, metavar="BITS",
                    help="normal octahedral bits, 7..16 "
                         "(encode + transcode)")
    ap.add_argument("-qg", type=int, default=None, metavar="BITS",
                    help="generic float attribute bits "
                         "(COLOR/TANGENT/WEIGHT; encode + transcode)")
    args = ap.parse_args(argv)
    resume = not args.no_resume

    cfg = None
    if any(v is not None for v in (args.qp, args.qt, args.qn, args.qg,
                                   args.compression_level)):
        from ..encode import Config
        from ..models import AttributeType
        cfg = (Config.from_level(args.compression_level)
               if args.compression_level is not None else Config())
        if args.qp is not None:
            cfg.quant_bits[AttributeType.POSITION] = args.qp
        if args.qt is not None:
            cfg.quant_bits[AttributeType.TEX_COORD] = args.qt
        if args.qn is not None:
            cfg.quant_bits[AttributeType.NORMAL] = args.qn
        if args.qg is not None:
            for t in (AttributeType.COLOR, AttributeType.TANGENT,
                      AttributeType.WEIGHT):
                cfg.quant_bits[t] = args.qg

    from ..device import resolve
    from ..parallel.batch import _device_quant_bits
    use_device = not args.host_only
    if use_device and (args.command == "decode"
                       or _device_quant_bits(cfg) is not None):
        try:
            resolve(args.device)
        except RuntimeError as e:
            print(f"torchdraco-corpus: no card for the device plane ({e}); "
                  f"pass --device cpu for its plain twins on the CPU, or "
                  f"--host-only for the host plane", file=sys.stderr)
            return 2

    if args.command == "encode":
        from ..parallel import BatchEncoder
        inputs = _expand(args.input, ENCODE_EXTS)
        plane = ("auto" if use_device and args.route == "auto"
                 else use_device)
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            import torch.distributed as dist

            from ..parallel import encode_corpus_multihost, init_distributed
            init_distributed()
            try:
                report = encode_corpus_multihost(
                    inputs, args.output, resume=resume, use_device=plane,
                    device=args.device, workers=args.workers, cfg=cfg,
                    device_window=args.window)
            finally:
                dist.destroy_process_group()
        else:
            report = BatchEncoder(cfg=cfg, use_device=plane,
                                  device=args.device).encode_corpus(
                inputs, args.output, resume=resume, workers=args.workers,
                device_window=args.window)
    elif args.command == "decode":
        from ..parallel import BatchDecoder
        inputs = _expand(args.input, DECODE_EXTS)
        report = BatchDecoder().decode_corpus(
            inputs, args.output, resume=resume, fmt=args.fmt,
            workers=args.workers, use_device=use_device, device=args.device)
    else:
        from ..parallel import transcode_corpus
        inputs = _expand(args.input, TRANSCODE_EXTS)
        report = transcode_corpus(inputs, args.output,
                                  use_device=use_device, resume=resume,
                                  khr_ids=args.khr_ids, cfg=cfg,
                                  device=args.device)

    json.dump(report, sys.stdout, indent=1)
    sys.stdout.write("\n")
    return 0 if not report.get("failed") else 1


if __name__ == "__main__":
    raise SystemExit(main())

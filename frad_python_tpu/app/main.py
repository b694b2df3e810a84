"""CLI entry dispatch (reference src/main.py): action -> pipeline."""

from __future__ import annotations

import os
import signal
import sys

from ..utils import cli

BANNER = (
    "                Fourier Analogue-in-Digital — JAX engine\n"
    "                  frad_python_tpu (JAX/XLA + C++ host)\n"
)

HELP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "help")


def main(argv: list[str] | None = None) -> None:
    signal.signal(signal.SIGINT, lambda *_: sys.exit(1))
    if os.environ.get("FRAD_TPU_WARM_HEAP"):
        # warm-heap allocator for demand-paged VMs; opt-in because it
        # pins RSS at the high-water mark and disables mmap allocations
        # for the whole process — right for bench/serve, not every CLI run
        from ..utils import hostmem
        hostmem.tune()
    argv = list(sys.argv if argv is None else argv)
    executable = os.path.basename(argv[0]) if argv else "frad-tpu"

    action, metaaction, input_file, params = cli.parse(argv)

    if action in cli.ENCODE_OPT:
        from . import encode
        encode.encode(input_file, params)
    elif action in cli.DECODE_OPT:
        from . import decode
        decode.decode(input_file, params, play=False)
    elif action in cli.PLAY_OPT:
        from . import decode
        decode.decode(input_file, params, play=True)
    elif action in cli.REPAIR_OPT:
        from . import repair
        repair.repair(input_file, params)
    elif action in cli.METADATA_OPT:
        from . import metadata
        metadata.modify(input_file, metaaction, params)
    elif action in cli.HELP_OPT:
        print(BANNER)
        topic = "general"
        for opts, name in ((cli.ENCODE_OPT, "encode"), (cli.DECODE_OPT, "decode"),
                           (cli.REPAIR_OPT, "repair"), (cli.PLAY_OPT, "play"),
                           (cli.METADATA_OPT, "metadata"),
                           (cli.JSONMETA_OPT, "jsonmeta"),
                           (cli.VORBISMETA_OPT, "vorbismeta"),
                           (cli.PROFILES_OPT, "profiles")):
            if input_file in opts:
                topic = name
                break
        path = os.path.join(HELP_DIR, f"{topic}.txt")
        print(open(path, encoding="utf-8").read().replace("{frad}", executable))
    else:
        print("Fourier Analogue-in-Digital — JAX engine", file=sys.stderr)
        print(f"Abstract syntax: {executable} [encode|decode|play|repair|meta] "
              f"<input> [flags...]", file=sys.stderr)
        print(f"Type `{executable} help` to get help.", file=sys.stderr)


if __name__ == "__main__":
    main()

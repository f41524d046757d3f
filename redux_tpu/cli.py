"""redux-tpu command line interface.

Parity with the reference binary (the reference's ``src/main.rs``)::

    redux-tpu (-c | -d) [-i <input file>] [-o <output file>]

* ``-c`` compress / ``-d`` decompress, exactly one required (main.rs:36-61);
* stdin/stdout defaults when ``-i``/``-o`` are omitted (main.rs:90-106);
* ratio summary printed to stderr (main.rs:112,117);
* exit codes: 1 = usage, 2 = file open, 3 = codec error
  (main.rs:87,95,104,113,118).

Extensions (flags the reference does not have):

* ``--format {rxt,redux}``: RXT1 block-parallel archive (default) or the
  reference's bare single-stream format (``redux``), which is produced and
  consumed sequentially and is byte-compatible with the reference CLI at
  its hardcoded ``Parameters(8, 30, 32)`` (main.rs:108);
* ``--block-size N``: symbols per block for the rxt format;
* ``--params S,F,C``: arithmetic parameters (validated like
  model/mod.rs:64);
* ``--no-prior``: disable the warm-start histogram prior.

Decompression auto-detects the format: RXT1 container magic, the
compact single-block magic (0xB3), else a bare reference stream.
"""

from __future__ import annotations

import sys

USAGE = "Usage: redux-tpu (-c | -d) [-i <input file>] [-o <output file>] [--format rxt|redux|auto] [--block-size N] [--params S,F,C] [--no-prior]"


def _parse_args(argv):
    opts = {
        "compress": None,
        "input": None,
        "output": None,
        "format": "rxt",
        "block_size": None,
        "params": None,
        "prior": True,
    }
    it = iter(argv)
    for arg in it:
        if arg == "-c":
            opts["compress"] = True
        elif arg == "-d":
            opts["compress"] = False
        elif arg == "-i":
            opts["input"] = next(it, None)
            if opts["input"] is None:
                return None
        elif arg == "-o":
            opts["output"] = next(it, None)
            if opts["output"] is None:
                return None
        elif arg == "--format":
            fmt = next(it, None)
            if fmt not in ("rxt", "redux", "auto"):
                return None
            opts["format"] = fmt
        elif arg == "--block-size":
            val = next(it, None)
            if val is None or not val.isdigit() or int(val) < 1:
                return None
            opts["block_size"] = int(val)
        elif arg == "--params":
            val = next(it, None)
            try:
                s, f, c = (int(x) for x in val.split(","))
            except (AttributeError, ValueError):
                return None
            opts["params"] = (s, f, c)
        elif arg == "--no-prior":
            opts["prior"] = False
        else:
            return None
    # Mode flag is mandatory (main.rs:59).
    if opts["compress"] is None:
        return None
    return opts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = _parse_args(argv)
    if opts is None:
        print(USAGE, file=sys.stderr)
        return 1

    # Late imports keep `redux-tpu -h`-style failures fast.
    from .errors import ReduxError
    from .params import Parameters

    try:
        params = (
            Parameters(*opts["params"]) if opts["params"] else Parameters.default()
        )
    except ReduxError as e:
        print(f"Invalid parameters: {e}", file=sys.stderr)
        return 1

    if opts["input"] is None:
        data = sys.stdin.buffer.read()
    else:
        try:
            with open(opts["input"], "rb") as f:
                data = f.read()
        except OSError as e:
            print(f"Error while opening input file {opts['input']}: {e}", file=sys.stderr)
            return 2

    try:
        if opts["compress"]:
            if opts["format"] == "redux":
                try:
                    from . import native

                    out = native.compress_bytes(data, params)
                except (ImportError, RuntimeError):
                    from . import oracle
                    from .models.fenwick import AdaptiveFenwickModel

                    out = oracle.compress_bytes(data, AdaptiveFenwickModel(params))
            elif opts["format"] == "auto":
                from . import api

                out = api.encode_auto(
                    data,
                    params=params,
                    **({"block_size": opts["block_size"]} if opts["block_size"] else {}),
                )
            else:
                from . import api

                kwargs = {}
                if opts["block_size"] is not None:
                    kwargs["block_size"] = opts["block_size"]
                if not opts["prior"]:
                    kwargs["use_prior"] = False
                out = api.encode(data, params=params, **kwargs)
            msg = (
                f"Compressed {len(data)} bytes into {len(out)} bytes, "
                f"ratio: {len(data) / len(out):.3f}"
                if out
                else "Compressed 0 bytes"
            )
        else:
            from . import api

            out = api.decode_auto(data, params=params)
            msg = (
                f"Decompressed {len(out)} bytes from {len(data)} bytes, "
                f"ratio: {len(out) / len(data):.3f}"
                if data
                else "Decompressed 0 bytes"
            )
    except ReduxError as e:
        mode = "Compression" if opts["compress"] else "Decompression"
        print(f"{mode} error: {e}", file=sys.stderr)
        return 3

    if opts["output"] is None:
        sys.stdout.buffer.write(out)
        sys.stdout.buffer.flush()
    else:
        try:
            with open(opts["output"], "wb") as f:
                f.write(out)
        except OSError as e:
            print(f"Error while opening output file {opts['output']}: {e}", file=sys.stderr)
            return 2

    print(msg, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

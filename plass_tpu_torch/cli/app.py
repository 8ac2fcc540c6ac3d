"""Command shell of the port's `plass` and `penguin` CLIs.

Each command takes the flag list of its JAX counterpart (cli/params.py, a
copy of the JAX package's registry, so a command line that `plass_tpu`
accepts parses to the same values here) plus `--device`. A bare boolean
flag toggles its value (Parameters.cpp:1670-1677). `--threads` and
`--backend` are accepted and ignored: the port's device is `--device`, and
its host stages take their threads from OpenMP and torch. `<command>
--help` lists a command's flags with their defaults. As the JAX package's
shell, it answers `version`/`--version`, `shellcompletion [command]` and,
for a mistyped command, "Did you mean".
"""
import dataclasses
import sys

from ..utils.log import logger, setup
from . import params as P

IGNORED = {
    "--threads": "Accepted and ignored (host stages use OpenMP's and "
                 "torch's own thread counts)",
    "--backend": "Accepted and ignored (the port's device is --device)",
}


def port_flags(flags):
    """The JAX command's flags, --threads and --backend marked ignored, and
    --device."""
    out = [dataclasses.replace(f, description=IGNORED[f.name])
           if f.name in IGNORED else f for f in flags]
    return out + [P.Flag(
        "--device", "device", str, "cuda",
        "Device of the kernels: cuda, cuda:<i>, or cpu for their plain "
        "PyTorch versions (cuda without a card is an error)")]


def port_space(flags):
    """A command's ParamSpace: its JAX flag list (port_flags), plus
    --device."""
    return P.ParamSpace(port_flags(flags))


@dataclasses.dataclass
class Command:
    name: str
    fn: object          # fn(positional, space, stats) -> exit code
    params_fn: object   # () -> ParamSpace with the command's defaults
    usage: str
    description: str
    hidden: bool = False


def _value_text(v):
    return v.format() if isinstance(v, P.MultiParam) else str(v)


def _command_help(binary, cmd):
    space = cmd.params_fn()
    lines = [f"usage: {binary} {cmd.name} {cmd.usage} [options]", "",
             cmd.description, "", "options:"]
    for f in space.flags.values():
        lines.append(f"  {f.name:28s} {f.description} "
                     f"[{_value_text(space.values[f.attr])}]")
    return "\n".join(lines)


def _levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _shellcompletion(commands, args):
    """The reference's `shellcompletion` tool (Application.cpp:124-182):
    no operand, the visible command names; one operand, that command's flag
    names (the contract util/bash-completion.sh consumes)."""
    if not args:
        print(" ".join(c.name for c in commands if not c.hidden) + " ")
        return 0
    for c in commands:
        if c.name == args[0]:
            print(" ".join(c.params_fn().flags.keys()) + " ")
            break
    print()
    return 0


def run_app(binary, commands, argv, stats=None):
    """Parse argv (a command, its flags and positional arguments) and run
    the command; returns the exit code. `stats` is handed to the command's
    workflow."""
    argv = list(argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(f"usage: {binary} <command> [<args>]\n\nCommands:")
        for c in commands:
            if not c.hidden:
                print(f"  {c.name:24s} {c.description}")
        return 0
    if argv[0] in ("version", "--version"):
        from .. import __version__
        print(__version__)
        return 0
    if argv[0] == "shellcompletion":
        return _shellcompletion(commands, argv[1:])
    name = argv[0]
    byname = {c.name: c for c in commands}
    if name not in byname:
        # a Levenshtein hint, as the JAX package's shell gives it
        best = min(byname, key=lambda n: _levenshtein(name, n))
        print(f"Invalid command '{name}'.", file=sys.stderr)
        if _levenshtein(name, best) <= max(2, len(name) // 2):
            print(f"Did you mean '{best}'?", file=sys.stderr)
        return 1
    cmd = byname[name]
    if "-h" in argv[1:] or "--help" in argv[1:]:
        print(_command_help(binary, cmd))
        return 0
    space = cmd.params_fn()
    try:
        positional = space.parse_args(argv[1:])
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        print(f"usage: {binary} {cmd.name} {cmd.usage}", file=sys.stderr)
        return 1
    setup(space.values.get("verbosity", 3))
    try:
        return cmd.fn(positional, space,
                      {} if stats is None else stats) or 0
    except (FileExistsError, FileNotFoundError, ValueError) as e:
        # a usage error or a missing or existing file, as the JAX
        # package's shell reports them
        logger.error("Error: %s", e)
        return 1

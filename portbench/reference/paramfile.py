"""The upstream parameter file (`centrolign -C`) of a job whose
configuration states `params`.

Some upstream parameters have no command-line option (the polish's
`max_realignment_cycle_size`, for one), and `-C <file>` replaces every
other argument that sets a parameter, the positional FASTA and `-v`
included. So for such a configuration the harness writes one file a job,
beside its FASTA, in the format `centrolign -G` writes: the
configuration's parameters, the job's `fasta_name` (and `tree_name` in
msa mode), and the `logging_level` a traced run needs. The file may be
partial: the program's defaults hold for every parameter it does not name.

`check` refuses a configuration that `-C` would change without a word;
`write` and `parse` are the file's two sides (reference/expected.py keys a
job by what `parse` reads). Imports nothing of the port.
"""

from __future__ import annotations

import re

# the parameters the harness writes for each job
OWNED = ("fasta_name", "tree_name", "logging_level")
# side outputs at fixed paths: runs would share them, and nothing judges them
SIDE_FILES = ("subproblems_prefix", "all_pairs_prefix",
              "subalignments_filepath", "bonds_prefix")
# the options that -C leaves in force (cli.py::_setup reads no other
# after it), with whether each takes a value; every other option sets a
# parameter that -C would override
KEPT = {"--force-gfa-output": False, "--hosts": True}
NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def check(config: dict) -> None:
    """Raise ValueError where a configuration's `params` cannot be written
    as a parameter file, or its `cli_args` hold an argument that -C would
    override (an option that sets a parameter, or a positional FASTA)."""
    params = config["params"]
    if not isinstance(params, dict):
        raise ValueError("params has to be an object of parameter names "
                         "and values")
    for name, value in params.items():
        if not NAME.match(name):
            raise ValueError(f"params: {name!r} is no parameter name")
        if name in OWNED or name in SIDE_FILES:
            raise ValueError(f"params: {name} is not a configuration's to "
                             f"set: the harness writes "
                             f"{', '.join(OWNED)} for each job, and no side "
                             f"files ({', '.join(SIDE_FILES)})")
        value_text(value)
    args = list(config.get("cli_args", []))
    k = 0
    while k < len(args):
        word = args[k]
        option = word.split("=", 1)[0]
        if option not in KEPT:
            raise ValueError(
                f"cli_args {word!r}: with params every job runs as -C "
                f"<file>, which overrides it; set it in params (the options "
                f"that stay: {', '.join(KEPT)})")
        k += 2 if KEPT[option] and "=" not in word else 1
    if k > len(args):
        raise ValueError(f"cli_args: {args[-1]!r} has no value")


def value_text(value) -> str:
    """A JSON value in the file's syntax: true/false, a number, three
    numbers joined by commas, or a string (quoted where it is empty or
    holds a space)."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if (isinstance(value, list) and len(value) == 3
            and all(isinstance(x, (int, float)) and not isinstance(x, bool)
                    for x in value)):
        return ",".join(repr(x) for x in value)
    if isinstance(value, str):
        # the format has no escapes: a comment starts at any '#'
        if any(c in value for c in '#"\n\r'):
            raise ValueError(f"params: {value!r} holds '#', '\"' or a line "
                             f"break, which the file cannot hold")
        return f'"{value}"' if not value or any(
            c.isspace() for c in value) else value
    raise ValueError(f"params: {value!r} is no parameter value (a bool, a "
                     f"number, three numbers or a string)")


def write(path: str, params: dict, fasta: str, tree: str | None = None,
          logging_level: int | None = None) -> None:
    """Write a job's parameter file: its FASTA (and tree), the logging
    level where one is given (else the program's default), then `params`."""
    lines = [("fasta_name", fasta)]
    if tree is not None:
        lines.append(("tree_name", tree))
    if logging_level is not None:
        lines.append(("logging_level", int(logging_level)))
    lines += list(params.items())
    with open(path, "w") as f:
        f.write("---\n" + "".join(f" {name}: {value_text(value)}\n"
                                  for name, value in lines))


def parse(text: str) -> dict:
    """{name: value text} of a parameter file, as the program reads it
    (params.py::Parameters._parse): after the first '---', a comment runs
    from '#' to the line's end, and each other line is `name: value`, the
    value unquoted."""
    cut = text.find("---")
    if cut != -1:
        text = text[cut + 3:]
    out = {}
    for line in text.splitlines():
        body = line.split("#", 1)[0]
        if not body.strip():
            continue
        name, sep, value = body.partition(":")
        if not sep:
            raise ValueError(f"parameter file line without ':': {line!r}")
        value = value.strip()
        if value.startswith('"') and value.endswith('"') and len(value) > 1:
            value = value[1:-1]
        out[name.strip()] = value
    return out

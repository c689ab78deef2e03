"""Config / flag system with cascading config files.

Re-implements the semantics of the reference's ``df::program_options_lite``
(dependencies/program-options-lite, used by every app, e.g.
PccAppTranscoder.cpp:91-240):

 * options are declared as ``(name, default, help)`` bound to a typed slot;
 * command line accepts ``--name=value``, ``--name value``, short ``-n value``;
 * ``-c file.cfg`` / ``--config=file.cfg`` parses a config file *in place*,
   so the MPEG CTC cascade ``common -> condition -> sequence -> rate`` works
   with **last value wins** semantics;
 * config file lines are ``Name : value`` or ``Name = value``; ``#`` starts a
   comment; unknown keys warn (not fail) to stay forward compatible.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
from typing import Any, Callable


def _parse_bool(s: str) -> bool:
    s = s.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


_CASTS: dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: lambda s: int(s, 0),
    float: float,
    str: lambda s: s.strip(),
}


@dataclasses.dataclass
class Option:
    name: str
    default: Any
    help: str = ""
    type: type = str
    short: str | None = None
    # for list-valued options (comma separated)
    element_type: type | None = None

    def cast(self, raw: str) -> Any:
        if self.element_type is not None:
            raw = raw.strip()
            if not raw:
                return []
            return [_CASTS[self.element_type](x) for x in raw.split(",")]
        return _CASTS[self.type](raw)


class OptionRegistry:
    """Holds declared options and parses CLI + cascading cfg files."""

    def __init__(self) -> None:
        self._options: dict[str, Option] = {}
        self._short: dict[str, str] = {}
        self.values: dict[str, Any] = {}
        self.warnings: list[str] = []

    # -- declaration -------------------------------------------------------
    def add(
        self,
        name: str,
        default: Any,
        help: str = "",
        short: str | None = None,
        element_type: type | None = None,
    ) -> "OptionRegistry":
        ty = type(default)
        if isinstance(default, list):
            ty = list
        opt = Option(
            name=name,
            default=default,
            help=help,
            type=ty if ty is not list else str,
            short=short,
            element_type=element_type,
        )
        key = name.lower()
        self._options[key] = opt
        if short:
            self._short[short] = key
        self.values[name] = default
        return self

    def declare_dataclass(self, params: Any, help_map: dict[str, str] | None = None):
        """Declare one option per field of a dataclass instance (field name =
        option name), so pipelines can expose their parameter structs directly."""
        for f in dataclasses.fields(params):
            val = getattr(params, f.name)
            if isinstance(val, (bool, int, float, str)):
                self.add(f.name, val, (help_map or {}).get(f.name, ""))
            elif isinstance(val, list) and val and isinstance(val[0], (int, float, str)):
                self.add(f.name, val, element_type=type(val[0]))
            elif isinstance(val, list):
                self.add(f.name, val, element_type=int)
        return self

    def apply_to_dataclass(self, params: Any) -> Any:
        for f in dataclasses.fields(params):
            if f.name in self.values:
                setattr(params, f.name, self.values[f.name])
        return params

    # -- setting -----------------------------------------------------------
    def _set(self, key: str, raw: str, source: str) -> None:
        k = key.lower()
        if k in ("c", "config"):
            self.parse_config_file(raw.strip())
            return
        opt = self._options.get(k)
        if opt is None:
            self.warnings.append(f"{source}: unknown option '{key}' ignored")
            return
        self.values[opt.name] = opt.cast(raw)

    # -- config files ------------------------------------------------------
    def parse_config_file(self, path: str) -> None:
        if not os.path.exists(path):
            raise FileNotFoundError(f"config file not found: {path}")
        for lineno, line in enumerate(open(path, "r", encoding="utf-8"), 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            for sep in (":", "="):
                if sep in line:
                    key, _, raw = line.partition(sep)
                    self._set(key.strip(), raw.strip(), f"{path}:{lineno}")
                    break
            else:
                self.warnings.append(f"{path}:{lineno}: unparseable line ignored")

    # -- CLI ---------------------------------------------------------------
    def parse_args(self, argv: list[str]) -> list[str]:
        """Parse CLI args; returns leftover positional args."""
        leftovers: list[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a.startswith("--"):
                body = a[2:]
                if "=" in body:
                    key, _, raw = body.partition("=")
                    self._set(key, raw, "cli")
                else:
                    opt = self._options.get(body.lower())
                    if body.lower() == "config" or (
                        opt is not None and opt.type is not bool
                    ):
                        if i + 1 >= len(argv):
                            raise ValueError(f"option --{body} expects a value")
                        i += 1
                        self._set(body, argv[i], "cli")
                    elif opt is not None:  # bare boolean flag
                        self.values[opt.name] = True
                    else:
                        self.warnings.append(f"cli: unknown option '--{body}' ignored")
            elif a.startswith("-") and len(a) > 1 and not a[1].isdigit():
                short = a[1:]
                if short == "c":
                    i += 1
                    self.parse_config_file(argv[i])
                elif short in self._short:
                    key = self._short[short]
                    opt = self._options[key]
                    if opt.type is bool:
                        self.values[opt.name] = True
                    else:
                        i += 1
                        self._set(key, argv[i], "cli")
                else:
                    self.warnings.append(f"cli: unknown option '-{short}' ignored")
            else:
                leftovers.append(a)
            i += 1
        return leftovers

    # -- introspection -----------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        return self.values[name]

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._options

    def help_text(self, title: str = "options") -> str:
        lines = [title]
        for opt in self._options.values():
            dv = opt.default
            lines.append(f"  --{opt.name:<40} {opt.help} (default: {dv})")
        return "\n".join(lines)


def parse_config_file(path: str) -> dict[str, str]:
    """Standalone cfg-file reader returning raw key->value strings (last wins)."""
    out: dict[str, str] = {}
    for line in open(path, "r", encoding="utf-8"):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        for sep in (":", "="):
            if sep in line:
                key, _, raw = line.partition(sep)
                out[key.strip()] = raw.strip()
                break
    return out

"""pio-env.sh loader (counterpart of ``predictionio_tpu/utils/config.py``;
reference: conf/pio-env.sh sourced by bin/pio).

The reference's launcher sources a shell file exporting PIO_* variables.
``load_pio_env`` parses the same file format (export lines, simple
assignments, comments, ${VAR} interpolation) without spawning a shell and
merges it into the process env so ``StorageConfig.from_env`` sees it.

The JAX module's other two functions configure JAX, which the port does
not have: ``apply_platform_override`` (``PIO_JAX_PLATFORM`` pins JAX's
backend) and ``enable_compilation_cache`` (XLA's persistent compilation
cache).  The port's device is ``PIO_TORCH_DEVICE``, read by the CLI, and
its kernel build cache is ``ops/build.py``'s; neither has a stand-in here.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, Optional

_ASSIGN = re.compile(r"^(?:export\s+)?([A-Za-z_][A-Za-z0-9_]*)=(.*)$")
_REF = re.compile(r"\$\{?([A-Za-z_][A-Za-z0-9_]*)\}?")


def load_pio_env(
    path: Optional[str] = None,
    apply: bool = True,
    base: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """Parse a pio-env.sh-style file; returns the variables it defines.

    Search order when path is None: $PIO_ENV_FILE, ./conf/pio-env.sh,
    ~/.pio/pio-env.sh.  Missing file → empty dict (defaults apply).
    """
    candidates = (
        [path]
        if path
        else [
            os.environ.get("PIO_ENV_FILE"),
            "conf/pio-env.sh",
            str(Path.home() / ".pio" / "pio-env.sh"),
        ]
    )
    found = next((c for c in candidates if c and Path(c).exists()), None)
    if found is None:
        return {}
    env: Dict[str, str] = dict(base if base is not None else os.environ)
    out: Dict[str, str] = {}
    for raw in Path(found).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _ASSIGN.match(line)
        if not m:
            continue
        name, value = m.group(1), m.group(2).strip()
        single_quoted = len(value) >= 2 and value[0] == value[-1] == "'"
        if value and value[0] == value[-1] and value[0] in "\"'" and len(value) >= 2:
            value = value[1:-1]
        if not single_quoted:
            # shell `source` semantics: no ${VAR} expansion inside 'single quotes'
            value = _REF.sub(lambda mm: env.get(mm.group(1), ""), value)
        env[name] = value
        out[name] = value
    if apply:
        os.environ.update(out)
    return out

"""SPICE jar wrapper (the port's own copy of
`cvc_tpu/evaluation/spice_jar.py`), used when a JVM and spice-1.0.jar are
present.

SPICE parses captions into scene graphs with a Java dependency parser, so
without a JVM `language_eval` reports SPICE as None (and the rule-based
SPICE_lite beside it). With one, this wrapper speaks pycocoevalcap's
spice.py protocol: write an input JSON of
  [{"image_id", "test", "refs": [...]}]
run `java -jar spice-*.jar input.json -cache <dir> -out output.json
-subset -silent`, and read per-image and mean scores from the output.
Set $CVC_SPICE_JAR to the jar path. No JVM is assumed: this wrapper runs
only where a deployment provides Java."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile


def find_spice_jar() -> str | None:
    p = os.environ.get("CVC_SPICE_JAR")
    if p and os.path.exists(p):
        return p
    return None


def jar_available() -> bool:
    return shutil.which("java") is not None and find_spice_jar() is not None


def compute_spice(candidates: dict[str, str],
                  references: dict[str, list[str]],
                  jar: str | None = None, mem: str = "8G"
                  ) -> tuple[float, dict[str, float]]:
    """Returns (mean SPICE F-score, {image_id: F-score})."""
    jar = jar or find_spice_jar()
    if jar is None:
        raise RuntimeError("no SPICE jar (set CVC_SPICE_JAR)")
    ids = list(candidates.keys())
    payload = [{"image_id": i, "test": candidates[i],
                "refs": list(references[i])} for i in ids]
    with tempfile.TemporaryDirectory() as td:
        in_path = os.path.join(td, "input.json")
        out_path = os.path.join(td, "output.json")
        cache = os.path.join(td, "cache")
        os.makedirs(cache, exist_ok=True)
        with open(in_path, "w") as f:
            json.dump(payload, f)
        subprocess.run(
            ["java", f"-Xmx{mem}", "-jar", jar, in_path,
             "-cache", cache, "-out", out_path, "-subset", "-silent"],
            check=True, cwd=os.path.dirname(os.path.abspath(jar)),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        with open(out_path) as f:
            results = json.load(f)
    per = {str(r["image_id"]): float(r["scores"]["All"]["f"])
           for r in results}
    mean = sum(per.values()) / max(len(per), 1)
    return mean, per

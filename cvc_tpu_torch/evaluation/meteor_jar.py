"""METEOR jar wrapper (the port's own copy of
`cvc_tpu/evaluation/meteor_jar.py`), used when a JVM and meteor-1.5.jar
are present.

It speaks pycocoevalcap's meteor.py line protocol:

    SCORE ||| ref1 ||| ref2 ... ||| hypothesis     -> stats line
    EVAL ||| stats                                  -> segment score
    final line after all segments                   -> corpus score

The jar path comes from $CVC_METEOR_JAR (or `meteor-1.5.jar` next to it).
No JVM is assumed: without one `jar_available()` is False and
`language_eval` scores METEOR with the pure-Python port in `meteor.py`;
this wrapper runs only where a deployment provides Java."""

from __future__ import annotations

import os
import shutil
import subprocess
import threading


def find_meteor_jar() -> str | None:
    p = os.environ.get("CVC_METEOR_JAR")
    if p and os.path.exists(p):
        return p
    return None


def jar_available() -> bool:
    return shutil.which("java") is not None and find_meteor_jar() is not None


class MeteorJar:
    """Long-lived jar subprocess (one JVM per evaluation run)."""

    def __init__(self, jar: str | None = None, mem: str = "2G"):
        self.jar = jar or find_meteor_jar()
        if self.jar is None:
            raise RuntimeError("no METEOR jar (set CVC_METEOR_JAR)")
        self.proc = subprocess.Popen(
            ["java", "-jar", f"-Xmx{mem}", self.jar, "-", "-", "-stdio",
             "-l", "en", "-norm"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1,
            cwd=os.path.dirname(os.path.abspath(self.jar)))
        self.lock = threading.Lock()

    def compute_score(self, candidates: dict[str, str],
                      references: dict[str, list[str]]
                      ) -> tuple[float, dict[str, float]]:
        ids = list(candidates.keys())
        with self.lock:
            eval_line = "EVAL"
            for i in ids:
                refs = [r.replace("|||", "").replace("  ", " ")
                        for r in references[i]]
                cand = candidates[i].replace("|||", "").replace("  ", " ")
                score_line = " ||| ".join(
                    ("SCORE", " ||| ".join(refs), cand))
                self.proc.stdin.write(score_line + "\n")
                stats = self.proc.stdout.readline().strip()
                eval_line += " ||| " + stats
            self.proc.stdin.write(eval_line + "\n")
            per = {i: float(self.proc.stdout.readline().strip())
                   for i in ids}
            corpus = float(self.proc.stdout.readline().strip())
        return corpus, per

    def close(self):
        try:
            self.proc.stdin.close()
            self.proc.kill()
        except Exception:
            pass

    def __del__(self):  # pragma: no cover
        self.close()

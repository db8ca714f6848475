"""Caption scoring: the METEOR 1.5 jar behind one subprocess, or a
unigram fallback when there is no Java or no jar.

Twin of `densecap_tpu/eval/meteor.py`, with the same records-in,
scores-out contract, the same chunked stdio protocol and the same
fallback. One difference: the jar at `eval/meteor/meteor-1.5.jar` is
looked up under the repository root (the directory above this package),
not under the current directory, so the scorer does not depend on where
a CLI runs from. `~/meteor-1.5.jar` is the second place looked at.
Fallback scores are not comparable with published METEOR numbers.

A record holds 'candidate' (a string) and 'references' (a list of
strings); its score is the best over its references, 0 with none.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from collections import Counter

# the repository root: <root>/densecap_tpu_torch/eval/meteor.py
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METEOR_CHUNK = 128


def _find_meteor_jar():
    if not shutil.which("java"):
        return None
    for p in (os.path.join(REPO_ROOT, "eval", "meteor", "meteor-1.5.jar"),
              os.path.expanduser("~/meteor-1.5.jar")):
        if os.path.exists(p):
            return p
    return None


def _fallback_pair_score(candidate: str, reference: str) -> float:
    """Recall-weighted harmonic mean (alpha 0.9) of unigram precision and
    recall: METEOR's base measure without its synonym and stem modules or
    its fragmentation penalty."""
    c = candidate.split()
    r = reference.split()
    if not c or not r:
        return 0.0
    overlap = sum((Counter(c) & Counter(r)).values())
    if overlap == 0:
        return 0.0
    p = overlap / len(c)
    rr = overlap / len(r)
    alpha = 0.9
    return p * rr / (alpha * p + (1 - alpha) * rr)


def score_captions_fallback(records):
    return [max((_fallback_pair_score(rec.get("candidate", ""), r)
                 for r in rec.get("references") or []), default=0.0)
            for rec in records]


def _clean(s):
    return s.replace("|||", "").replace("\n", " ").replace("  ", " ")


def _meteor_cmd(jar):
    """The jar's invocation (the reference bridge's); tests substitute it
    to drive the protocol against a scripted process."""
    return ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en",
            "-norm"]


def score_captions_meteor(records, jar, chunk=METEOR_CHUNK):
    """Score with one METEOR process in stdio mode.

    Per record, one `SCORE ||| ref1 ||| ... ||| refN ||| hypothesis` line
    yields a stats line, and `EVAL ||| <stats>` yields the score. Records
    go in chunks: `chunk` SCORE lines, their stats, then the EVAL lines
    and their scores. A chunk's pending output stays well under the 64
    KiB pipe buffer, so neither side blocks. Records with no references
    score 0 and never reach the jar.
    """
    proc = subprocess.Popen(
        _meteor_cmd(jar), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        cwd=os.path.dirname(os.path.abspath(jar)) or None)
    scores = [0.0] * len(records)
    idxs = [i for i, rec in enumerate(records) if rec.get("references")]
    try:
        for base in range(0, len(idxs), chunk):
            grp = idxs[base:base + chunk]
            lines = []
            for i in grp:
                refs = [_clean(r) for r in records[i]["references"]]
                hyp = _clean(records[i].get("candidate", ""))
                lines.append("SCORE ||| " + " ||| ".join(refs)
                             + " ||| " + hyp + "\n")
            proc.stdin.write("".join(lines))
            proc.stdin.flush()
            stats = [proc.stdout.readline().strip() for _ in grp]
            proc.stdin.write("".join(f"EVAL ||| {s}\n" for s in stats))
            proc.stdin.flush()
            for i in grp:
                scores[i] = float(proc.stdout.readline().strip())
    finally:
        proc.stdin.close()
        proc.wait()
    return scores


def score_captions(records):
    """{'scores': [...], 'method': 'meteor' | 'fallback'}. A jar that
    fails falls back, as in the JAX package, and says so."""
    jar = _find_meteor_jar()
    if jar is not None:
        try:
            return {"scores": score_captions_meteor(records, jar),
                    "method": "meteor"}
        except (OSError, ValueError) as e:
            print(f"METEOR jar failed ({e}); using fallback scorer")
    return {"scores": score_captions_fallback(records), "method": "fallback"}

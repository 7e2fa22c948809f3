"""LLM label verification: batch reports + weak labels through an LLM judge.

Counterpart of ``mmrp_tpu/data/verify.py``, copied (numpy and the standard
library only; nothing of JAX).

Parity with the reference Gemini verifier (reference:
src/DataHandler/verify_labels_with_gemini.py:30-314): reports are batched
into prompts listing the weak labels, the LLM returns per-record verdicts
``{llm_status, remove, add}``, Unknown rows are retried in a second pass,
and the verdicts are applied to the one-hot label table
(finalOutputData.py:18-82 -> ``*_final`` CSV with a final_labels column).

Zero-egress design: the LLM client is an injected callable
``complete(prompt) -> str``; the reference's key-rotation/backoff loop
(verify_labels_with_gemini.py:69-118) becomes a retrying wrapper around any
client. With no client, verification is a no-op pass-through (offline mode),
and cached verdict files are honored.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

PROMPT_TEMPLATE = """You are a radiology label auditor. For each numbered report,
check the proposed labels. Reply with a JSON list; one object per report:
{{"index": <n>, "llm_status": "Correct"|"Wrong"|"Unknown",
  "remove": [<labels to remove>], "add": [<labels to add>]}}
Valid labels: {label_space}

{reports}"""


@dataclass
class Verdict:
    llm_status: str = "Unknown"
    remove: List[str] = field(default_factory=list)
    add: List[str] = field(default_factory=list)


class LabelVerifier:
    def __init__(
        self,
        complete: Optional[Callable[[str], str]] = None,
        label_space: Optional[Sequence[str]] = None,
        batch_size: int = 8,
        max_retries: int = 3,
        backoff_s: float = 1.0,
        cache_path: Optional[str] = None,
    ):
        if label_space is None:
            from mmrp_tpu_torch.labels import LABEL_COLS

            label_space = LABEL_COLS
        self.complete = complete
        self.label_space = list(label_space)
        self.batch_size = batch_size
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.cache_path = cache_path
        self.cache: Dict[str, dict] = {}
        if cache_path and Path(cache_path).exists():
            try:
                self.cache = json.loads(Path(cache_path).read_text())
            except (json.JSONDecodeError, OSError):
                self.cache = {}

    # -- prompting ---------------------------------------------------------

    def _prompt(self, batch: Sequence[Tuple[str, str, List[str]]]) -> str:
        lines = []
        for i, (_, report, labels) in enumerate(batch):
            lines.append(f"Report {i}: {report}\nProposed labels: {labels}")
        return PROMPT_TEMPLATE.format(
            label_space=", ".join(self.label_space), reports="\n\n".join(lines)
        )

    def _call_llm(self, prompt: str) -> Optional[List[dict]]:
        if self.complete is None:
            return None
        for attempt in range(self.max_retries):
            try:
                text = self.complete(prompt)
                start = text.find("[")
                end = text.rfind("]")
                if start < 0 or end < 0:
                    raise ValueError("no JSON list in response")
                return json.loads(text[start : end + 1])
            except Exception as e:  # noqa: BLE001 — retry w/ backoff
                if attempt == self.max_retries - 1:
                    print(f"[verify] giving up after {attempt + 1} tries: {e}")
                    return None
                time.sleep(self.backoff_s * (2**attempt))
        return None

    # -- verification -----------------------------------------------------------

    def verify(
        self, records: Sequence[dict], retry_unknown: bool = True
    ) -> Dict[str, Verdict]:
        """records: [{id, report_text, labels (binary vec)}] -> id -> Verdict."""
        todo = []
        verdicts: Dict[str, Verdict] = {}
        for rec in records:
            rid = rec["id"]
            if rid in self.cache:
                verdicts[rid] = Verdict(**self.cache[rid])
                continue
            names = [
                self.label_space[i]
                for i, on in enumerate(rec["labels"])
                if on and i < len(self.label_space)
            ]
            todo.append((rid, rec["report_text"], names))

        if self.complete is None:  # offline: everything not cached stays Unknown
            for rid, _, _ in todo:
                verdicts.setdefault(rid, Verdict())
            return verdicts

        def run_pass(items):
            unknowns = []
            for s in range(0, len(items), self.batch_size):
                batch = items[s : s + self.batch_size]
                resp = self._call_llm(self._prompt(batch))
                if resp is None:
                    unknowns.extend(batch)
                    continue
                by_index = {int(r.get("index", -1)): r for r in resp if isinstance(r, dict)}
                for i, (rid, rep, labels) in enumerate(batch):
                    r = by_index.get(i)
                    if r is None:
                        unknowns.append((rid, rep, labels))
                        continue
                    v = Verdict(
                        llm_status=str(r.get("llm_status", "Unknown")),
                        remove=[x for x in r.get("remove", []) if x in self.label_space],
                        add=[x for x in r.get("add", []) if x in self.label_space],
                    )
                    if v.llm_status == "Unknown":
                        unknowns.append((rid, rep, labels))
                    verdicts[rid] = v
            return unknowns

        unknowns = run_pass(todo)
        if retry_unknown and unknowns:  # second chance (reference :198-255)
            run_pass(unknowns)
        for rid, v in verdicts.items():
            self.cache[rid] = {"llm_status": v.llm_status, "remove": v.remove,
                               "add": v.add}
        self._save_cache()
        return verdicts

    def _save_cache(self) -> None:
        if not self.cache_path:
            return
        p = Path(self.cache_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.cache, indent=1))
        os.replace(tmp, p)


def gemini_client_from_env(
    model: str = "gemini-2.5-flash",
    env_var: str = "GEMINI_KEYS",
) -> Optional[Callable[[str], str]]:
    """Build a rotating-key Gemini ``complete`` callable from the environment.

    Reference behavior (verify_labels_with_gemini.py:69-118,289-295): >=20
    comma-separated keys in ``GEMINI_KEYS``, rotate on quota errors, evict
    invalid keys. Returns None when the SDK or keys are absent (offline
    mode) — callers fall back to cached/Unknown verdicts.
    """
    keys = [k.strip() for k in os.environ.get(env_var, "").split(",") if k.strip()]
    if not keys:
        return None
    try:
        from google import genai  # type: ignore
    except ImportError:
        return None

    state = {"idx": 0, "keys": list(keys)}

    def complete(prompt: str) -> str:
        last_err: Optional[Exception] = None
        for _ in range(len(state["keys"])):
            key = state["keys"][state["idx"] % len(state["keys"])]
            try:
                client = genai.Client(api_key=key)
                resp = client.models.generate_content(model=model, contents=prompt)
                return resp.text or ""
            except Exception as e:  # noqa: BLE001 — rotate / evict and retry
                last_err = e
                msg = str(e).lower()
                if "invalid" in msg or "unauthorized" in msg:
                    state["keys"].remove(key)  # evict dead key
                    if not state["keys"]:
                        break
                else:
                    state["idx"] += 1  # quota/transient: rotate
        raise RuntimeError(f"all Gemini keys failed: {last_err}")

    return complete


def apply_verdicts(
    records: Sequence[dict],
    verdicts: Dict[str, Verdict],
    label_space: Optional[Sequence[str]] = None,
) -> List[dict]:
    """Apply remove/add lists -> new records with final labels
    (reference finalOutputData.py:18-82). Unknown/missing verdicts leave the
    weak labels untouched."""
    if label_space is None:
        from mmrp_tpu_torch.labels import LABEL_COLS

        label_space = LABEL_COLS
    idx = {name: i for i, name in enumerate(label_space)}
    out = []
    for rec in records:
        vec = list(rec["labels"])
        v = verdicts.get(rec["id"])
        if v is not None and v.llm_status != "Unknown":
            for name in v.remove:
                if name in idx:
                    vec[idx[name]] = 0
            for name in v.add:
                if name in idx:
                    vec[idx[name]] = 1
        new = dict(rec)
        new["labels"] = vec
        new["final_labels"] = [label_space[i] for i, on in enumerate(vec) if on]
        out.append(new)
    return out

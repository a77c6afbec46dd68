"""Eval/observability: per-stage metrics for the encoder.

The reference interleaves JSON frames *in-band* via sentinel bytes
(src/eval.rs:7-105, EvalWriter state machine :192-402) and strips them back
out. Since our streams are assembled host-side, we record out-of-band:
each scope captures the byte range it wrote plus arbitrary key/value pairs,
producing the same JSON tree shape the analyzer consumes.
"""

from __future__ import annotations

import json
import time


class EvalRecorder:
    """Hierarchical scope recorder. Pass to encode(..., recorder=...)."""

    def __init__(self) -> None:
        self.root: dict = {"name": "root", "children": [], "data": {}}
        self._stack = [self.root]

    def scope_begin(self, name: str, writer=None) -> None:
        node = {"name": name, "children": [], "data": {},
                "_start": len(writer) if writer is not None else None,
                "_t0": time.perf_counter()}
        self._stack[-1]["children"].append(node)
        self._stack.append(node)

    def scope_end(self, writer=None) -> None:
        node = self._stack.pop()
        if node.get("_start") is not None and writer is not None:
            node["data"]["bytes"] = len(writer) - node.pop("_start")
        else:
            node.pop("_start", None)
        node["data"]["seconds"] = round(time.perf_counter() - node.pop("_t0"), 6)

    def write_pair(self, key: str, value) -> None:
        self._stack[-1]["data"][key] = value

    def to_json(self) -> dict:
        def clean(n):
            return {"name": n["name"], "data": n["data"],
                    "children": [clean(c) for c in n["children"]]}
        return clean(self.root)

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, indent=1)


class NullRecorder:
    """No-op recorder so instrumentation costs nothing when disabled."""

    def scope_begin(self, name, writer=None):
        pass

    def scope_end(self, writer=None):
        pass

    def write_pair(self, key, value):
        pass


NULL = NullRecorder()

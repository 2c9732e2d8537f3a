"""HTTP scheduler extender client.

Reference: plugin/pkg/scheduler/extender.go (HTTPExtender:39, Filter:96,
Prioritize:120 — JSON POST {pod, nodes} to urlPrefix/apiVersion/verb).
This is the documented out-of-process extension boundary
(docs/design/scheduler_extender.md); the TPU sidecar can also be fronted
by one of these for Go-source-compatible deployments.

Copy of kubernetes_tpu/scheduler/extender.py: only the import package differs.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple
from urllib import request as urlrequest

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.runtime import scheme as default_scheme
from kubernetes_tpu_torch.scheduler.policy import ExtenderConfig


class ExtenderError(Exception):
    pass


class HTTPExtender:
    def __init__(self, config: ExtenderConfig, scheme=None):
        self.config = config
        self.scheme = scheme or default_scheme

    @property
    def weight(self) -> int:
        return self.config.weight

    def _post(self, verb: str, payload: Dict) -> Dict:
        url = (
            f"{self.config.url_prefix.rstrip('/')}/"
            f"{self.config.api_version}/{verb}"
        )
        data = json.dumps(payload).encode()
        req = urlrequest.Request(url, data=data, method="POST")
        req.add_header("Content-Type", "application/json")
        try:
            with urlrequest.urlopen(req, timeout=self.config.http_timeout) as r:
                if r.status != 200:
                    raise ExtenderError(f"{url}: status {r.status}")
                return json.loads(r.read())
        except ExtenderError:
            raise
        except Exception as e:
            raise ExtenderError(f"{url}: {e}")

    def filter(
        self, pod: Pod, nodes: Sequence[Node]
    ) -> Tuple[List[Node], Dict[str, str]]:
        """extender.go:96 Filter -> (filtered nodes, failed{node: reason}).
        A missing filterVerb passes everything through."""
        if not self.config.filter_verb:
            return list(nodes), {}
        payload = {
            "pod": self.scheme.encode(pod),
            "nodes": {
                "kind": "NodeList",
                "items": [self.scheme.encode(n) for n in nodes],
            },
        }
        result = self._post(self.config.filter_verb, payload)
        if result.get("error"):
            raise ExtenderError(result["error"])
        items = (result.get("nodes") or {}).get("items", [])
        filtered = [self.scheme.decode(i) for i in items]
        failed = dict(result.get("failedNodes") or {})
        return filtered, failed

    def prioritize(
        self, pod: Pod, nodes: Sequence[Node]
    ) -> List[Tuple[str, int]]:
        """extender.go:120 Prioritize -> [(host, score)] (unweighted; the
        caller applies config.weight, generic_scheduler.go:276-298)."""
        if not self.config.prioritize_verb:
            return [(n.metadata.name, 0) for n in nodes]
        payload = {
            "pod": self.scheme.encode(pod),
            "nodes": {
                "kind": "NodeList",
                "items": [self.scheme.encode(n) for n in nodes],
            },
        }
        result = self._post(self.config.prioritize_verb, payload)
        return [
            (hp["host"], int(hp["score"]))
            for hp in (result or [])
        ] if isinstance(result, list) else [
            (hp["host"], int(hp["score"]))
            for hp in result.get("hostPriorityList", result.get("items", []))
        ]

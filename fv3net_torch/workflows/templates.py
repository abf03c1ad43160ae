"""Argo-style WorkflowTemplates executed locally (a copy of the host-only
``fv3net_tpu/workflows/templates.py``).  The port's templates call the
``fv3net_torch`` modules as ``python -m fv3net_torch....`` (a checkout
runs them without installing the package: pass its root on
``PYTHONPATH`` through ``env``), and every template whose tasks touch
tensors takes a ``device`` parameter (default ``cuda``) that it hands to
each CLI's ``--device``.

reference: workflows/argo/ — ~15 Argo WorkflowTemplates (DAG tasks with
parameters, dependencies, retries) submitted to k8s, plus
external/fv3kube/fv3kube/utils.py:29 ``wait_for_complete`` job polling.
There is no cluster here, so the same template *shape* (entrypoint,
inputs.parameters with defaults, dag.tasks with dependencies and
``{{...}}`` substitution, retryStrategy) runs as local subprocesses in
topological order.  Templates live in ``fv3net_torch/workflows/argo/``.
"""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import yaml

TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "argo")

_SUBST = re.compile(r"\{\{\s*([^}]+?)\s*\}\}")


def _substitute(text: str, scope: Mapping[str, str]) -> str:
    def repl(m):
        key = m.group(1)
        if key not in scope:
            raise KeyError(f"unresolved template parameter {{{{{key}}}}}")
        return str(scope[key])

    return _SUBST.sub(repl, text)


@dataclasses.dataclass
class TaskResult:
    name: str
    returncode: int
    stdout: str
    stderr: str
    attempts: int
    seconds: float

    @property
    def succeeded(self) -> bool:
        return self.returncode == 0


@dataclasses.dataclass
class Task:
    name: str
    command: List[str]
    dependencies: List[str]
    retries: int = 0
    backoff_seconds: float = 0.0


class WorkflowTemplate:
    """One parsed template file (Argo WorkflowTemplate subset: metadata,
    spec.entrypoint, spec.templates[].inputs.parameters / dag.tasks /
    script.command, retryStrategy.limit)."""

    def __init__(self, doc: Mapping[str, Any]):
        if doc.get("kind") != "WorkflowTemplate":
            raise ValueError("not a WorkflowTemplate document")
        self.name = doc["metadata"]["name"]
        self.spec = doc["spec"]
        self.entrypoint = self.spec["entrypoint"]
        self._templates = {t["name"]: t for t in self.spec["templates"]}

    @classmethod
    def load(cls, path_or_name: str) -> "WorkflowTemplate":
        path = path_or_name
        if not os.path.exists(path):
            path = os.path.join(TEMPLATE_DIR, path_or_name + ".yaml")
        with open(path) as f:
            return cls(yaml.safe_load(f))

    def parameters(self, name: Optional[str] = None) -> Dict[str, Optional[str]]:
        """Declared inputs (None = required) of a template."""
        t = self._templates[name or self.entrypoint]
        out: Dict[str, Optional[str]] = {}
        for p in t.get("inputs", {}).get("parameters", []):
            out[p["name"]] = p.get("value")
        return out

    def resolve_tasks(self, parameters: Mapping[str, str]) -> List[Task]:
        """Flatten the entrypoint DAG into runnable tasks with all
        ``{{inputs.parameters.*}}`` references substituted."""
        declared = self.parameters()
        params = dict(declared)
        params.update(parameters)
        missing = [k for k, v in params.items() if v is None]
        if missing:
            raise ValueError(f"missing required parameters: {missing}")
        unknown = set(parameters) - set(declared)
        if unknown:
            raise ValueError(f"unknown parameters: {sorted(unknown)}")
        scope = {f"inputs.parameters.{k}": v for k, v in params.items()}

        entry = self._templates[self.entrypoint]
        tasks: List[Task] = []
        if "script" in entry and "dag" not in entry:
            # plain script entrypoint (e.g. reference
            # workflows/argo/resolve-output-url.yaml): the entrypoint
            # template itself is the single task.
            script = entry["script"]
            cmd = [_substitute(str(c), scope) for c in script["command"]]
            if "source" in script:
                cmd = cmd + [_substitute(script["source"], scope)]
            retry = entry.get("retryStrategy", {})
            return [
                Task(
                    name=self.entrypoint,
                    command=cmd,
                    dependencies=[],
                    retries=int(retry.get("limit", 0)),
                    backoff_seconds=float(
                        retry.get("backoff", {}).get("duration", "0").rstrip("s")
                        or 0
                    ),
                )
            ]
        for t in entry.get("dag", {}).get("tasks", []):
            ref = self._templates[t["template"]]
            local = dict(scope)
            for a in t.get("arguments", {}).get("parameters", []):
                local[f"inputs.parameters.{a['name']}"] = _substitute(
                    str(a["value"]), scope
                )
            script = ref["script"]
            cmd = [_substitute(str(c), local) for c in script["command"]]
            if "source" in script:
                cmd = cmd + [_substitute(script["source"], local)]
            retry = ref.get("retryStrategy", {})
            tasks.append(
                Task(
                    name=t["name"],
                    command=cmd,
                    dependencies=list(t.get("dependencies", [])),
                    retries=int(retry.get("limit", 0)),
                    backoff_seconds=float(
                        retry.get("backoff", {}).get("duration", "0").rstrip("s")
                        or 0
                    ),
                )
            )
        return tasks


def _toposort(tasks: Sequence[Task]) -> List[Task]:
    by_name = {t.name: t for t in tasks}
    done: List[str] = []
    out: List[Task] = []
    remaining = list(tasks)
    while remaining:
        ready = [
            t for t in remaining if all(d in done for d in t.dependencies)
        ]
        if not ready:
            raise ValueError(
                "dependency cycle or unknown dependency among "
                f"{[t.name for t in remaining]}"
            )
        for t in ready:
            out.append(t)
            done.append(t.name)
            remaining.remove(t)
    del by_name
    return out


def run_workflow(
    template: WorkflowTemplate,
    parameters: Mapping[str, str],
    workdir: Optional[str] = None,
    env: Optional[Mapping[str, str]] = None,
    timeout: Optional[float] = None,
) -> Dict[str, TaskResult]:
    """Execute a template's DAG locally (the `argo submit` +
    fv3kube.wait_for_complete analog): tasks run as subprocesses in
    dependency order; a failed task (after retries) stops the workflow
    and raises RuntimeError, mirroring argo's failed-workflow status."""
    results: Dict[str, TaskResult] = {}
    full_env = dict(os.environ)
    full_env.update(env or {})
    for task in _toposort(template.resolve_tasks(parameters)):
        attempts = 0
        t0 = time.time()
        while True:
            attempts += 1
            proc = subprocess.run(
                task.command,
                cwd=workdir,
                env=full_env,
                capture_output=True,
                text=True,
                timeout=timeout,
            )
            if proc.returncode == 0 or attempts > task.retries:
                break
            if task.backoff_seconds:
                time.sleep(task.backoff_seconds * attempts)
        results[task.name] = TaskResult(
            name=task.name,
            returncode=proc.returncode,
            stdout=proc.stdout,
            stderr=proc.stderr,
            attempts=attempts,
            seconds=time.time() - t0,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"workflow {template.name} failed at task {task.name} "
                f"(rc={proc.returncode}, {attempts} attempts):\n"
                f"{proc.stderr[-2000:]}"
            )
    return results


def list_templates() -> List[str]:
    return sorted(
        f[:-5] for f in os.listdir(TEMPLATE_DIR) if f.endswith(".yaml")
    )

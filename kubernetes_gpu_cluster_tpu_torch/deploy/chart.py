"""Helm-workflow parity: package rendered manifests as an installable chart.

The reference's operator workflow was ``helm install/upgrade vllm
vllm/vllm-stack -f values.yaml`` with helm's release history behind it
(reference ``old_README.md:1079-1082,1467-1470``). This framework's source
of truth is the typed Python renderer (deploy/render.py — every reference
values file renders and is test-covered), so the chart is GENERATED from it
rather than hand-maintained as Go templates that could silently drift:

    kgct-torch-render -f values.yaml --emit-chart ./kgct-stack
    helm install kgct ./kgct-stack          # first deploy
    # edit values.yaml ...
    kgct-torch-render -f values.yaml --emit-chart ./kgct-stack
    helm upgrade kgct ./kgct-stack          # rolling upgrade
    helm rollback kgct 1                    # helm-native rollback
    helm history kgct

The emitted templates contain no template directives (helm still runs them
through the Go template engine, so literal ``{{`` in operator values — e.g.
a Jinja chat-template arg — is escaped at emission), making the chart a
first-class release object: upgrades diff against the stored release,
rollbacks restore previous manifests, ``helm uninstall`` garbage-collects —
the full workflow the reference relied on, with the values schema unchanged.
The original values are embedded as the chart's values.yaml for the record
(and surfaced by ``helm get values``).
"""

from __future__ import annotations

import os

import yaml

from .render import render_values

CHART_NAME = "kgct-stack"
CHART_VERSION = "0.4.0"


def _escape_go_template(text: str) -> str:
    """Helm runs every templates/ file through the Go template engine;
    operator values passed through verbatim (env, extraArgs) may contain
    ``{{`` (e.g. Jinja chat templates), which would fail `helm install` with
    'function not defined'. Emit them as the literal action {{"{{"}}."""
    return text.replace("{{", '{{"{{"}}')


def emit_chart(values: dict, out_dir: str) -> list[str]:
    """Write an installable Helm chart for ``values`` (reference schema).
    Returns the list of files written (relative to ``out_dir``). Re-emitting
    into the same directory replaces the whole templates/ set — stale
    manifests from a previous emit would otherwise survive into the next
    `helm upgrade` and keep deploying resources the operator removed."""
    manifests = render_values(values)
    tdir = os.path.join(out_dir, "templates")
    os.makedirs(tdir, exist_ok=True)
    for old in os.listdir(tdir):
        if old.endswith((".yaml", ".yml", ".txt")):
            os.unlink(os.path.join(tdir, old))
    written: list[str] = []

    models = [s.get("name") for s in
              (values.get("servingEngineSpec") or {}).get("modelSpec") or []]
    chart = {
        "apiVersion": "v2",
        "name": CHART_NAME,
        "description": ("PyTorch/CUDA LLM serving stack (engine + router), "
                        "generated from the kgct renderer — values schema "
                        "compatible with the reference vllm-stack chart"),
        "type": "application",
        "version": CHART_VERSION,
        "appVersion": CHART_VERSION,
        "keywords": ["gpu", "llm", "serving", "cuda"],
    }
    with open(os.path.join(out_dir, "Chart.yaml"), "w") as f:
        yaml.safe_dump(chart, f, sort_keys=False)
    written.append("Chart.yaml")

    # The operator's values, embedded verbatim: `helm get values --all`
    # then shows exactly what this chart was generated from.
    with open(os.path.join(out_dir, "values.yaml"), "w") as f:
        yaml.safe_dump(values, f, sort_keys=False)
    written.append("values.yaml")

    for fname, manifest in sorted(manifests.items()):
        with open(os.path.join(tdir, fname), "w") as f:
            f.write(_escape_go_template(
                yaml.safe_dump(manifest, sort_keys=False)))
        written.append(os.path.join("templates", fname))

    notes = (
        "kgct-stack deployed.\n\n"
        f"Models: {', '.join(str(m) for m in models)}\n\n"
        "Reach the OpenAI-compatible API through the router (the\n"
        "reference's port-forward workflow, old_README.md:1472-1476):\n\n"
        "  kubectl port-forward --address 0.0.0.0 "
        "svc/kgct-router-service 30080:80\n"
        "  curl http://localhost:30080/v1/models\n\n"
        "Upgrade: re-run `kgct-render -f values.yaml --emit-chart <dir>`\n"
        "and `helm upgrade <release> <dir>`. Roll back with\n"
        "`helm rollback <release> <revision>`.\n")
    with open(os.path.join(tdir, "NOTES.txt"), "w") as f:
        f.write(notes)
    written.append(os.path.join("templates", "NOTES.txt"))

    helmignore = "*.swp\n*.bak\n*.tmp\n.git/\n"
    with open(os.path.join(out_dir, ".helmignore"), "w") as f:
        f.write(helmignore)
    written.append(".helmignore")
    return written

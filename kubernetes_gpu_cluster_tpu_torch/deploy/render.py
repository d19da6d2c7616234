"""Render the reference's Helm-values schema into k8s manifests for GPU nodes
that run the PyTorch/CUDA port.

Input schema (kept field-for-field compatible with the reference so its nine
values files work unmodified — ``values-01-minimal-example8.yaml:6-62`` is
the fullest example):

    servingEngineSpec:
      runtimeClassName: "crun"          # passthrough
      modelSpec:
        - name, repository, tag, imagePullPolicy
          modelURL                      # HF id, preset name, or local path
          replicaCount
          requestCPU / requestMemory / requestGPU   # cards per pod
          vllmConfig: {tensorParallelSize, pipelineParallelSize,
                       gpuMemoryUtilization, maxModelLen, extraArgs}
          env / shmSize / extraVolumes / extraVolumeMounts
          nodeSelector / affinity / topologySpreadConstraints / tolerations
          raySpec: {headNode: {...}}    # -> torch.distributed StatefulSet
      routerSpec: {replicaCount, servicePort}       # optional

Mapping decisions (the port's engine, not a vLLM translation):

- ``requestGPU`` becomes ``nvidia.com/gpu`` (advertised by the port's
  device plugin, ``cluster/device-plugin-cuda``); the count is also the
  default tensor-parallel size when vllmConfig does not pin one, matching
  how the reference used N GPUs with ``--tensor-parallel-size N``. The port runs one process a card: a pod
  whose layout holds more ranks than there are pods starts its
  ``world / pods`` ranks itself (``serving/api_server.py``).
- ``vllmConfig`` maps onto this framework's engine CLI
  (serving/api_server.py): tensorParallelSize -> --tensor-parallel-size,
  pipelineParallelSize -> --pipeline-parallel-size, gpuMemoryUtilization ->
  --hbm-utilization, maxModelLen -> --max-model-len; extraArgs pass through
  verbatim (unknown vLLM flags are rejected by the CLI rather than silently
  dropped).
- ``raySpec`` (the reference's cross-node PP vehicle, KubeRay head/workers —
  ``old_README.md:1570-1625``) renders as a StatefulSet + headless Service:
  stable pod DNS replaces the Ray head address, ``KGCT_COORDINATOR`` points
  every rank at pod 0, and torch.distributed replaces the Ray object/RPC
  layer. ``KGCT_NUM_PROCESSES`` = pipelineParallelSize, the pod count.
- A router Deployment/Service fronts all model Deployments
  (serving/router.py), playing vllm-router-service's role
  (``old_README.md:1174-1176``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Optional

import yaml

from ..utils import get_logger

logger = get_logger("deploy.render")

DEFAULT_IMAGE = "ghcr.io/kgct/cuda-serving:v0.3.0"
ENGINE_PORT = 8000
ROUTER_PORT = 8080
COORD_PORT = 8476       # torch.distributed coordinator (rank 0)
CONTROL_PORT = 8477     # step-directive channel (serving/multihost.py)

_PART_OF = "kgct-stack"


def _labels(name: str, component: str) -> dict:
    return {
        "app.kubernetes.io/name": _PART_OF,
        "app.kubernetes.io/component": component,
        "app.kubernetes.io/instance": name,
    }


def _scrape_annotations(port: int) -> dict:
    """prometheus.io discovery annotations: every rendered serving pod
    exposes /metrics (engine histograms / router per-replica aggregation),
    so a stock Prometheus with the standard annotation-based kubernetes_sd
    relabeling scrapes the whole stack with zero extra config."""
    return {
        "prometheus.io/scrape": "true",
        "prometheus.io/port": str(port),
        "prometheus.io/path": "/metrics",
    }


# Multi-tenant QoS values-schema keys per tier (camelCase like every other
# vllmConfig knob) -> the engine CLI's snake_case JSON.
_QOS_TIER_KEYS = {"name", "weight", "priority", "maxConcurrent",
                  "ttftBudgetMs", "users"}


def _qos_tiers_arg(cfg: dict, where: str) -> Optional[tuple[str,
                                                            Optional[str]]]:
    """``qosTiers`` (list of tier objects — a LIST so duplicate names are
    detectable) + optional ``qosDefaultTier`` -> (the ``--qos-tiers`` CLI
    JSON, the default tier). Unknown keys, duplicate or malformed tier
    names, non-positive weights, and a qosDefaultTier naming an
    unconfigured tier all fail the RENDER — never the pod at start."""
    tiers = cfg.get("qosTiers")
    if tiers is None:
        if cfg.get("qosDefaultTier") is not None:
            raise ValueError(f"{where}: qosDefaultTier requires qosTiers")
        return None
    from ..config.qos import parse_qos_tiers, tiers_to_json
    if not isinstance(tiers, list) or not tiers:
        raise ValueError(f"{where}: qosTiers must be a non-empty list of "
                         "tier objects ({name, weight, priority, "
                         "maxConcurrent, ttftBudgetMs, users})")
    obj: dict = {}
    for t in tiers:
        if not isinstance(t, dict) or not t.get("name"):
            raise ValueError(f"{where}: every qosTiers entry needs a "
                             "'name'")
        name = str(t["name"])
        unknown = set(t) - _QOS_TIER_KEYS
        if unknown:
            raise ValueError(
                f"{where}: qosTiers entry {name!r} has unknown key(s) "
                f"{', '.join(sorted(unknown))} "
                f"(known: {', '.join(sorted(_QOS_TIER_KEYS))})")
        if name in obj:
            raise ValueError(f"{where}: duplicate qosTiers name {name!r}")
        spec_out: dict = {}
        if t.get("weight") is not None:
            spec_out["weight"] = t["weight"]
        if t.get("priority") is not None:
            spec_out["priority"] = t["priority"]
        if t.get("maxConcurrent") is not None:
            spec_out["max_concurrent"] = t["maxConcurrent"]
        if t.get("ttftBudgetMs") is not None:
            spec_out["ttft_budget_ms"] = t["ttftBudgetMs"]
        if t.get("users"):
            if not isinstance(t["users"], (list, tuple)):
                # A YAML scalar (`users: alice`) would list() into
                # characters and silently pin bogus one-char tenants.
                raise ValueError(
                    f"{where}: qosTiers entry {name!r} users must be a "
                    "LIST of tenant keys")
            spec_out["users"] = list(t["users"])
        obj[name] = spec_out
    try:
        parsed = parse_qos_tiers(json.dumps(obj))
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None
    default = cfg.get("qosDefaultTier")
    if default is not None and str(default) not in {t.name for t in parsed}:
        raise ValueError(
            f"{where}: qosDefaultTier {default!r} is not a configured "
            f"tier (configured: {', '.join(t.name for t in parsed)})")
    return tiers_to_json(parsed), (str(default) if default is not None
                                   else None)


def _engine_args(spec: dict, role: Optional[str] = None,
                 peer_urls: Optional[list[str]] = None) -> list[str]:
    cfg = spec.get("vllmConfig") or {}
    args = ["--model", str(spec["modelURL"]),
            "--port", str(ENGINE_PORT)]
    if role is not None:
        # Disaggregated prefill/decode: phase-dedicated replica pools
        # (prefillReplicas/decodeReplicas). "both" is the engine default
        # and renders no flag — byte-identical manifests for
        # non-disaggregated specs.
        args += ["--role", role]
        if role == "decode":
            # KV-pull allowlist: the decode pod only fetches handoffs from
            # its spec's prefill pods — a client reaching the pod directly
            # (per-pod DNS) cannot point the pull elsewhere (SSRF guard).
            args += ["--prefill-pool", ",".join(_prefill_urls(spec))]
    tp = cfg.get("tensorParallelSize")
    pp = cfg.get("pipelineParallelSize")
    if tp is None and spec.get("requestGPU", 1) > 1:
        # The reference ran N GPUs as TP=N; N cards per pod default the same
        # way (with PP, each pod still tensor-shards over its own cards —
        # otherwise all but one card per pod would sit idle).
        tp = spec["requestGPU"]
    if tp is not None:
        args += ["--tensor-parallel-size", str(tp)]
    if pp is not None:
        args += ["--pipeline-parallel-size", str(pp)]
    if cfg.get("gpuMemoryUtilization") is not None:
        args += ["--hbm-utilization", str(cfg["gpuMemoryUtilization"])]
    if cfg.get("maxModelLen") is not None:
        args += ["--max-model-len", str(cfg["maxModelLen"])]
    if cfg.get("swapSpaceGB") is not None:
        # Two-tier KV cache: host-DRAM swap space for preempt-by-swap and
        # prefix-spill (vLLM swapSpace parity). The pod's requestMemory must
        # budget for it on top of the process baseline.
        args += ["--swap-space-gb", str(cfg["swapSpaceGB"])]
    if cfg.get("quantization"):
        # Weight-only quant ladder (int8 / int4) — the knob the reference's
        # values schema hinted at via quantized-checkpoint modelURLs; here
        # it applies to any checkpoint at load (ops/quant.py).
        args += ["--quantization", str(cfg["quantization"])]
        if cfg.get("quantGroupSize") is not None:
            args += ["--quant-group-size", str(cfg["quantGroupSize"])]
    if cfg.get("enablePrefixCaching"):
        args += ["--enable-prefix-caching"]
    # Stall-free mixed prefill/decode batching (the TTFT QoS lever) is the
    # ENGINE default now; the values schema opts out with an explicit
    # ``enableMixedBatch: false`` (``true``/absent both render no flag).
    if cfg.get("enableMixedBatch") is False:
        args += ["--disable-mixed-batch"]
    if cfg.get("decodePriorityTokenBudget") is not None:
        args += ["--decode-priority-token-budget",
                 str(cfg["decodePriorityTokenBudget"])]
    spec_knobs = [k for k in ("specDraftModel", "specAdaptiveK", "specKMax")
                  if cfg.get(k)]
    if cfg.get("specKMax") is not None and not cfg.get("specAdaptiveK"):
        raise ValueError(
            f"modelSpec '{spec['name']}': specKMax requires "
            "specAdaptiveK: true (without the controller the ladder "
            "ceiling has no consumer — it would silently raise the "
            "static draft length instead)")
    if spec_knobs and not cfg.get("enableSpecDecode"):
        # Mirror of the engine CLI's argparse hygiene: a silently dropped
        # draft-model/adaptive-k knob would leave the operator believing
        # speculation is tuned while the pod serves plain decode.
        raise ValueError(
            f"modelSpec '{spec['name']}': {'/'.join(spec_knobs)} requires "
            "enableSpecDecode: true")
    if spec_knobs and _is_multihost(spec):
        raise ValueError(
            f"modelSpec '{spec['name']}': {'/'.join(spec_knobs)} does not "
            "compose with multihost/raySpec or pipelineParallelSize > 1 — "
            "the engine has no spec-verify forward path under pp meshes "
            "and the draft model cannot join SPMD lockstep; drop the spec "
            "knobs or serve the model single-host")
    if cfg.get("enableSpecDecode"):
        # Speculative decoding: n-gram drafting + batched verification;
        # composes with mixed batching (verify slices ride the chunk's
        # device step) and optionally with a draft MODEL + adaptive k.
        args += ["--enable-spec-decode"]
        if cfg.get("numSpeculativeTokens") is not None:
            args += ["--num-speculative-tokens",
                     str(cfg["numSpeculativeTokens"])]
        if cfg.get("specDraftModel"):
            args += ["--spec-draft-model", str(cfg["specDraftModel"])]
        if cfg.get("specAdaptiveK"):
            args += ["--spec-adaptive-k"]
        if cfg.get("specKMax") is not None:
            args += ["--spec-k-max", str(cfg["specKMax"])]
    qos = _qos_tiers_arg(cfg, f"modelSpec '{spec['name']}'")
    if qos is not None:
        # Multi-tenant QoS: tier table -> weighted fair scheduling,
        # priority preemption, per-tier admission budgets + shed
        # accounting on the engine; the router gets the same table
        # (_render_router) so both layers resolve identically.
        args += ["--qos-tiers", qos[0]]
        if qos[1] is not None:
            args += ["--qos-default-tier", qos[1]]
    peers_emitted = False
    if cfg.get("migrationBudgetSeconds") is not None:
        # Session survivability: live KV migration on drain makes SIGTERM
        # transfer-bound, so the engine's wait-it-out fallback must fit the
        # same (much tighter) budget — drain_grace_s mirrors the knob that
        # also derives terminationGracePeriodSeconds in _pod_spec.
        args += ["--drain-grace-s", str(int(cfg["migrationBudgetSeconds"]))]
        if peer_urls:
            # Drain-push allowlist (mirror of --prefill-pool): the SIGTERM
            # drain may only migrate running streams to sibling pods of the
            # same pool — a client reaching the pod directly cannot point
            # the push at an arbitrary URL (SSRF guard).
            args += ["--peer-pool", ",".join(peer_urls)]
            peers_emitted = True
    if cfg.get("fleetPrefixCache"):
        # Fleet-wide KV reuse: the N per-pod prefix caches become one
        # fleet cache — peers pull the ring owner's cached prefix on
        # affinity overflow and evictions remote-spill to sibling host
        # tiers. --peer-pool doubles as the pull/spill allowlist (same
        # SSRF guard as the drain push); topology validation
        # (per-pod-addressed StatefulSets only) runs in _render_model.
        args += ["--fleet-prefix-cache"]
        if peer_urls and not peers_emitted:
            args += ["--peer-pool", ",".join(peer_urls)]
    if cfg.get("integrityChecks") is False:
        # KV wire-plane integrity (per-page checksums + frame digest on
        # every handoff/prefix/spill/migration frame) defaults ON — only
        # an explicit ``integrityChecks: false`` renders the opt-out
        # (wire bytes byte-identical to the pre-integrity encoders, for
        # mixed fleets mid-upgrade); absent/true renders nothing.
        args += ["--no-integrity-checks"]
    # enableChunkedPrefill needs no flag: long prompts always chunk here.
    if os.path.isabs(str(spec["modelURL"])):
        # Local checkpoint dir (hostPath-mounted): weights + tokenizer live
        # there (reference local-model story, values-…3.yaml:22-30).
        args += ["--weights", str(spec["modelURL"]),
                 "--tokenizer", str(spec["modelURL"])]
    args += [str(a) for a in cfg.get("extraArgs") or []]
    return args


# Graceful-drain pod timing: the preStop sleep that lets endpoint removal
# propagate before SIGTERM, and the post-drain margin for flight-recorder
# dumps + process exit before SIGKILL.
PRESTOP_SLEEP_S = 5
DRAIN_EXIT_MARGIN_S = 10


def _pod_spec(spec: dict, engine: dict, multihost: bool,
              role: Optional[str] = None,
              peer_urls: Optional[list[str]] = None) -> dict:
    name = spec["name"]
    gpus = int(spec.get("requestGPU", 0) or 0)
    resources: dict[str, Any] = {"requests": {}, "limits": {}}
    if spec.get("requestCPU") is not None:
        resources["requests"]["cpu"] = spec["requestCPU"]
    if spec.get("requestMemory"):
        resources["requests"]["memory"] = spec["requestMemory"]
        resources["limits"]["memory"] = spec["requestMemory"]
    if gpus:
        resources["requests"]["nvidia.com/gpu"] = gpus
        resources["limits"]["nvidia.com/gpu"] = gpus

    volumes = list(spec.get("extraVolumes") or [])
    mounts = list(spec.get("extraVolumeMounts") or [])
    if spec.get("shmSize"):
        # Parity knob: torch.distributed's gloo and NCCL stage through shm.
        if not any(v.get("name") == "dshm" for v in volumes):
            volumes.append({"name": "dshm",
                            "emptyDir": {"medium": "Memory",
                                         "sizeLimit": spec["shmSize"]}})
            mounts.append({"name": "dshm", "mountPath": "/dev/shm"})

    env = list(spec.get("env") or [])
    if multihost:
        pp = (spec.get("vllmConfig") or {}).get("pipelineParallelSize", 1)
        env += [
            {"name": "KGCT_COORDINATOR",
             "value": f"kgct-{name}-engine-0.kgct-{name}-engine-hl:{COORD_PORT}"},
            {"name": "KGCT_NUM_PROCESSES", "value": str(pp)},
            {"name": "KGCT_PROCESS_ID",
             "valueFrom": {"fieldRef": {
                 "fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"}}},
        ]

    container = {
        "name": "serving-engine",
        "image": engine["image"],
        "imagePullPolicy": spec.get("imagePullPolicy", "IfNotPresent"),
        "command": ["python", "-m",
                    "kubernetes_gpu_cluster_tpu_torch.serving.api_server"],
        "args": (_engine_args(spec, role=role, peer_urls=peer_urls)
                 + (["--distributed"] if multihost else [])),
        "ports": [{"containerPort": ENGINE_PORT, "name": "http"}],
        "resources": resources,
        "readinessProbe": {
            "httpGet": {"path": "/health", "port": ENGINE_PORT},
            "initialDelaySeconds": 10, "periodSeconds": 5},
        "livenessProbe": {
            "httpGet": {"path": "/health", "port": ENGINE_PORT},
            "initialDelaySeconds": 120, "periodSeconds": 10,
            "failureThreshold": 6},
        # Graceful drain contract (serving SIGTERM handler): the preStop
        # sleep lets endpoint-controller removal propagate BEFORE SIGTERM
        # lands, so no new connections race the drain; the engine then stops
        # admitting (503 + Retry-After), finishes in-flight streams, and
        # exits on its own — terminationGracePeriodSeconds must outlast the
        # engine's drain_grace_s (120 s default) or SIGKILL truncates
        # streams the drain was built to protect.
        "lifecycle": {"preStop": {"exec": {
            "command": ["sh", "-c", f"sleep {PRESTOP_SLEEP_S}"]}}},
    }
    if env:
        container["env"] = env
    if mounts:
        container["volumeMounts"] = mounts

    # terminationGracePeriodSeconds: with live KV migration on drain
    # (vllmConfig.migrationBudgetSeconds) the SIGTERM path is TRANSFER-bound
    # — each running stream's KV pages push to a peer in seconds — so the
    # pod needs only budget + preStop + exit margin before SIGKILL, not the
    # decode-bound default of 150 (drain_grace_s 120 + the same margins)
    # that waits out the longest in-flight decode.
    mig_budget = (spec.get("vllmConfig") or {}).get("migrationBudgetSeconds")
    if mig_budget is not None:
        mig_budget = int(mig_budget)
        if mig_budget < 1:
            raise ValueError(
                f"modelSpec '{name}': migrationBudgetSeconds must be >= 1 "
                f"(got {mig_budget})")
        grace = mig_budget + PRESTOP_SLEEP_S + DRAIN_EXIT_MARGIN_S
    else:
        grace = 150
    pod: dict[str, Any] = {"containers": [container],
                           "terminationGracePeriodSeconds": grace}
    if volumes:
        pod["volumes"] = volumes
    if engine.get("runtimeClassName"):
        pod["runtimeClassName"] = engine["runtimeClassName"]
    for key in ("nodeSelector", "affinity", "topologySpreadConstraints",
                "tolerations"):
        if spec.get(key):
            pod[key] = spec[key]
    return pod


def _disagg(spec: dict) -> Optional[tuple[int, int]]:
    """(prefillReplicas, decodeReplicas) when the modelSpec opts into
    disaggregated prefill/decode serving; None otherwise. Both knobs must
    be set together (a one-sided pool is a topology nobody can route),
    and the mode does not compose with multihost — a pipeline group is
    one step-lockstepped routing target that cannot split phases."""
    name = spec.get("name", "?")
    pf, dc = spec.get("prefillReplicas"), spec.get("decodeReplicas")
    if pf is None and dc is None:
        return None
    if pf is None or dc is None:
        raise ValueError(
            f"modelSpec '{name}': prefillReplicas and decodeReplicas must "
            "be set together (one-sided pools cannot be routed)")
    pf, dc = int(pf), int(dc)
    if pf < 1 or dc < 1:
        raise ValueError(
            f"modelSpec '{name}': prefillReplicas/decodeReplicas must "
            f"both be >= 1 (got {pf}/{dc})")
    if _is_multihost(spec):
        raise ValueError(
            f"modelSpec '{name}': disaggregated prefill/decode does not "
            "compose with multihost/raySpec (a pipeline group steps in "
            "SPMD lockstep and cannot split phases)")
    return pf, dc


def _is_multihost(spec: dict) -> bool:
    """One StatefulSet-of-ranks pod group (vs N independent replica pods).
    The ONE definition: the workload-kind choice in _render_model and the
    router-addressing choice in _replica_urls must always agree, or the
    router would resolve per-pod DNS names a different workload kind never
    creates."""
    cfg = spec.get("vllmConfig") or {}
    return bool(spec.get("raySpec")) or cfg.get("pipelineParallelSize", 1) > 1


def _pod_urls(name: str, count: int) -> list[str]:
    """Stable per-pod DNS names of a StatefulSet + headless Service."""
    return [f"http://kgct-{name}-engine-{i}.kgct-{name}-engine-hl:"
            f"{ENGINE_PORT}" for i in range(count)]


def _replica_urls(spec: dict, affinity: bool) -> list[str]:
    """The router's view of one modelSpec's CLIENT-FACING pool: either the
    model's Service (one URL; kube-proxy balances across pods behind it)
    or — in prefix-affinity mode, where kube-proxy's random pod choice
    would scatter a session's requests and destroy the cache locality the
    ring exists to protect — one stable per-pod DNS name per replica
    (StatefulSet + headless Service), so the hash ring owns individual
    pods. Disaggregated specs always address pods directly: both pools'
    rings must own individual replicas."""
    name = spec["name"]
    disagg = _disagg(spec)
    if disagg is not None:
        return _pod_urls(f"{name}-decode", disagg[1])
    if not affinity or _is_multihost(spec):
        # Multihost keeps its rank-0 Service even under affinity: client
        # traffic must only reach rank 0 (it drives every rank's step),
        # so the group IS one routing target.
        return [f"http://kgct-{name}-engine-svc:{ENGINE_PORT}"]
    return _pod_urls(name, int(spec.get("replicaCount", 1)))


def _prefill_urls(spec: dict) -> list[str]:
    """Per-pod URLs of the modelSpec's PREFILL pool (empty when the spec
    is not disaggregated)."""
    disagg = _disagg(spec)
    if disagg is None:
        return []
    return _pod_urls(f"{spec['name']}-prefill", disagg[0])


def _render_disagg_model(spec: dict, engine: dict,
                         disagg: tuple[int, int]) -> dict[str, dict]:
    """Disaggregated modelSpec -> role-split manifests: one StatefulSet +
    headless Service per phase pool. Both pools are StatefulSets with
    per-pod DNS regardless of routing policy — the prefill ring must own
    individual pods (a kube-proxy VIP would re-scatter the prefix keys),
    and the decode pool is addressed per-pod for session affinity the
    same way prefix-affinity addresses colocated replicas."""
    name = spec["name"]
    out: dict[str, dict] = {}
    for role, count in (("prefill", disagg[0]), ("decode", disagg[1])):
        pool = f"{name}-{role}"
        labels = _labels(pool, "serving-engine")
        # Decode pods are the only stream holders: under a migration
        # budget their SIGTERM drain pushes running streams to pool
        # siblings (prefill pods hold no streams and get no peer pool).
        peers = _pod_urls(pool, count) if role == "decode" else None
        pod = {"metadata": {"labels": labels,
                            "annotations": _scrape_annotations(ENGINE_PORT)},
               "spec": _pod_spec(spec, engine, False, role=role,
                                 peer_urls=peers)}
        out[f"{name}-{role}-engine-statefulset.yaml"] = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {"name": f"kgct-{pool}-engine", "labels": labels},
            "spec": {
                "serviceName": f"kgct-{pool}-engine-hl",
                "replicas": count,
                "podManagementPolicy": "Parallel",
                "selector": {"matchLabels": labels},
                "template": pod,
            },
        }
        out[f"{name}-{role}-engine-headless-svc.yaml"] = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"kgct-{pool}-engine-hl",
                         "labels": labels},
            "spec": {
                "clusterIP": "None",
                # The router (and decode-side KV pulls) probe pods
                # directly; per-pod DNS must resolve from the moment the
                # pod exists.
                "publishNotReadyAddresses": True,
                "selector": labels,
                "ports": [{"name": "http", "port": ENGINE_PORT}],
            },
        }
    return out


def _render_model(spec: dict, engine: dict,
                  affinity: bool = False) -> dict[str, dict]:
    """One modelSpec entry -> its manifests {filename: manifest}."""
    name = spec["name"]
    cfg = spec.get("vllmConfig") or {}
    disagg = _disagg(spec)
    if cfg.get("fleetPrefixCache"):
        # Fleet-wide KV reuse federates the LOCAL prefix cache across
        # pods that can address each other directly — both preconditions
        # are render-time-checkable, so a misconfiguration fails the
        # render with guidance instead of shipping an inert (or
        # unroutable) fleet cache (same pattern as affinity routing's
        # StatefulSet requirement).
        if not cfg.get("enablePrefixCaching"):
            raise ValueError(
                f"modelSpec '{name}': fleetPrefixCache requires "
                "enablePrefixCaching: true — the fleet cache federates "
                "the per-replica prefix cache; with caching off there is "
                "nothing to export, import, or spill")
        if _is_multihost(spec):
            raise ValueError(
                f"modelSpec '{name}': fleetPrefixCache does not compose "
                "with multihost/raySpec — a pipeline group steps in SPMD "
                "lockstep and cannot import peer KV on rank 0 alone")
        if disagg is None and not affinity:
            raise ValueError(
                f"modelSpec '{name}': fleetPrefixCache needs stable "
                "per-pod addresses for peer pulls and spills; a plain-"
                "Service Deployment cannot be addressed pod-by-pod — set "
                "routingPolicy: prefix-affinity (renders a StatefulSet + "
                "headless Service per replica, and the router's overflow "
                "hints are what trigger pulls) or use disaggregated "
                "prefill/decode pools")
    if disagg is not None:
        return _render_disagg_model(spec, engine, disagg)
    multihost = _is_multihost(spec)
    labels = _labels(name, "serving-engine")
    sel = {"matchLabels": labels}
    meta = {"name": f"kgct-{name}-engine", "labels": labels}
    # Peer pool for drain migration: only per-pod-addressed siblings can be
    # named (the affinity StatefulSet). A Deployment's pods have no stable
    # DNS (migration falls back to the trust-the-network default), and a
    # multihost group is ONE lockstepped serving target with no peers.
    peers = (_pod_urls(name, int(spec.get("replicaCount", 1)))
             if affinity and not multihost else None)
    pod = {"metadata": {"labels": labels,
                        "annotations": _scrape_annotations(ENGINE_PORT)},
           "spec": _pod_spec(spec, engine, multihost, peer_urls=peers)}
    out: dict[str, dict] = {}

    if multihost:
        # Stable DNS identities for torch.distributed ranks (the reference
        # used a Ray head + KubeRay for this role).
        out[f"{name}-engine-statefulset.yaml"] = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": meta,
            "spec": {
                "serviceName": f"kgct-{name}-engine-hl",
                "replicas": cfg.get("pipelineParallelSize", 1),
                "podManagementPolicy": "Parallel",
                "selector": sel,
                "template": pod,
            },
        }
        out[f"{name}-engine-headless-svc.yaml"] = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"kgct-{name}-engine-hl", "labels": labels},
            "spec": {
                "clusterIP": "None",
                # Per-pod DNS must resolve BEFORE readiness: rank 0's
                # torch.distributed coordinator and directive connects are what
                # MAKE the pods ready (standard StatefulSet peer discovery).
                "publishNotReadyAddresses": True,
                "selector": labels,
                "ports": [
                    {"name": "http", "port": ENGINE_PORT},
                    {"name": "coordinator", "port": COORD_PORT},
                    {"name": "directives", "port": CONTROL_PORT},
                ],
            },
        }
    elif affinity:
        # Prefix-affinity routing needs STABLE per-replica addresses (the
        # ring maps keys to pods, and a key must keep resolving to the same
        # pod across router restarts and peer churn): a StatefulSet gives
        # each replica the DNS identity kgct-<name>-engine-<i>.<headless>,
        # which _replica_urls enumerates into the router's --replicas.
        out[f"{name}-engine-statefulset.yaml"] = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": meta,
            "spec": {
                "serviceName": f"kgct-{name}-engine-hl",
                "replicas": spec.get("replicaCount", 1),
                "podManagementPolicy": "Parallel",
                "selector": sel,
                "template": pod,
            },
        }
        out[f"{name}-engine-headless-svc.yaml"] = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"kgct-{name}-engine-hl", "labels": labels},
            "spec": {
                "clusterIP": "None",
                # The router runs its own health probes and circuit
                # breaking; per-pod DNS must resolve from the moment the
                # pod exists so the startup probe can find it.
                "publishNotReadyAddresses": True,
                "selector": labels,
                "ports": [{"name": "http", "port": ENGINE_PORT}],
            },
        }
    else:
        out[f"{name}-engine-deployment.yaml"] = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": meta,
            "spec": {
                "replicas": spec.get("replicaCount", 1),
                "selector": sel,
                "template": pod,
            },
        }
    # Multihost: client traffic must land on rank 0 ONLY — it drives the
    # step of every rank by directives; a request served by a peer rank would
    # enter collectives the other ranks never join and hang the process
    # group. The pod-index label (set by the StatefulSet controller) pins the
    # Service to rank 0.
    svc_selector = dict(labels)
    if multihost:
        svc_selector["apps.kubernetes.io/pod-index"] = "0"
    out[f"{name}-engine-svc.yaml"] = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": f"kgct-{name}-engine-svc", "labels": labels},
        "spec": {
            "selector": svc_selector,
            "ports": [{"name": "http", "port": ENGINE_PORT,
                       "targetPort": ENGINE_PORT}],
        },
    }
    return out


def _render_router(replica_urls: list[str], router_spec: dict,
                   routing: Optional[dict] = None,
                   prefill_urls: Optional[list[str]] = None
                   ) -> dict[str, dict]:
    labels = _labels("router", "router")
    replicas = ",".join(replica_urls)
    routing = routing or {}
    policy_args: list[str] = []
    if prefill_urls:
        # Disaggregated prefill/decode: the router owns the phase split —
        # completions stream from --replicas (decode pool) while the
        # forwarded x-kgct-prefill-url header names the prefix-affine
        # member of this pool.
        policy_args += ["--prefill-replicas", ",".join(prefill_urls)]
    if routing.get("policy"):
        policy_args += ["--routing-policy", str(routing["policy"])]
    if routing.get("affinityPrefixLen") is not None:
        policy_args += ["--affinity-prefix-len",
                        str(routing["affinityPrefixLen"])]
    if routing.get("balanceFactor") is not None:
        policy_args += ["--balance-factor", str(routing["balanceFactor"])]
    if routing.get("qos"):
        # Same validated tier table the engine pods got (one resolution
        # order across both layers).
        qos_json, qos_default = routing["qos"]
        policy_args += ["--qos-tiers", qos_json]
        if qos_default is not None:
            policy_args += ["--qos-default-tier", qos_default]
    return {
        "router-deployment.yaml": {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": "kgct-router", "labels": labels},
            "spec": {
                "replicas": router_spec.get("replicaCount", 1),
                "selector": {"matchLabels": labels},
                "template": {
                    # The router pod IS a scrape target now: its /metrics
                    # is the fleet aggregation point — router-owned series
                    # (affinity hit ratio, per-replica locality gauges,
                    # retries/scrape-error counters) exist nowhere else.
                    # Caveat for dashboards: the router also re-exports
                    # every engine's series relabeled with replica="...",
                    # so fleet-wide sum()/rate() over ENGINE families must
                    # group by scrape job (or filter on the replica label)
                    # to avoid counting each sample twice — documented in
                    # README "Observability".
                    "metadata": {"labels": labels,
                                 "annotations": _scrape_annotations(
                                     ROUTER_PORT)},
                    "spec": {"containers": [{
                        "name": "router",
                        "image": router_spec.get("image", DEFAULT_IMAGE),
                        "command": [
                            "python", "-m",
                            "kubernetes_gpu_cluster_tpu_torch.serving.router"],
                        "args": ["--replicas", replicas,
                                 "--port", str(ROUTER_PORT)] + policy_args,
                        "ports": [{"containerPort": ROUTER_PORT}],
                        "readinessProbe": {
                            "httpGet": {"path": "/health",
                                        "port": ROUTER_PORT},
                            "periodSeconds": 5},
                    }]},
                },
            },
        },
        # The service the reference port-forwarded (old_README.md:1472-1476):
        # kubectl port-forward svc/kgct-router-service 30080:80
        "router-svc.yaml": {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "kgct-router-service",
                         "labels": labels},
            "spec": {
                "selector": labels,
                "ports": [{"name": "http",
                           "port": router_spec.get("servicePort", 80),
                           "targetPort": ROUTER_PORT}],
            },
        },
    }


def _quantity(x: float) -> str:
    """k8s resource.Quantity spelling for a small decimal (HPA
    AverageValue targets): milli-units keep sub-1.0 values exact."""
    return f"{int(round(float(x) * 1000))}m"


def _render_hpa(spec: dict, affinity: bool) -> dict[str, dict]:
    """autoscaling.enabled -> one autoscaling/v2 HPA per modelSpec, driven
    by the landed autoscaler signals (ROADMAP 4(b)): queue-wait pressure
    (``kgct_queue_wait_seconds`` p90 via a prometheus-adapter rule) and
    the shed rate (``rate(kgct_requests_shed_total[1m])``). The SLO gauge
    ``kgct_slo_ttft_attainment_ratio`` is deliberately NOT a scale metric
    — it FALLS under load, the inverse of HPA's scale-up direction — so it
    rides along as the alerting guardrail, documented in the annotations.

    Deployment topology only: prefix-affinity / disaggregated /multihost
    specs route a STATIC per-pod replica list rendered into the router
    args, which an HPA would silently outgrow (scale-up pods no traffic,
    scale-down pods 502s). Those topologies fail the RENDER with
    guidance rather than shipping an autoscaler that fights the ring."""
    name = spec["name"]
    auto = spec.get("autoscaling") or {}
    if not auto.get("enabled"):
        return {}
    if _is_multihost(spec):
        raise ValueError(
            f"modelSpec '{name}': autoscaling.enabled does not compose "
            "with multihost/raySpec — the StatefulSet's replica count IS "
            "the pipeline world size, not a capacity knob")
    if affinity or _disagg(spec) is not None:
        raise ValueError(
            f"modelSpec '{name}': autoscaling.enabled requires the "
            "Deployment topology (least-inflight, service-balanced). "
            "prefix-affinity and disaggregated pools render a STATIC "
            "per-pod replica list into the router args; an HPA would "
            "scale pods the ring never owns. Scale those topologies by "
            "re-rendering with a new replicaCount (only ~K/N keys remap "
            "— watch kgct_router_ring_remaps_total)")
    minr = int(auto.get("minReplicas", 1))
    maxr = int(auto.get("maxReplicas",
                        max(2 * int(spec.get("replicaCount", 1)),
                            minr + 1)))
    if maxr < minr:
        raise ValueError(f"modelSpec '{name}': autoscaling maxReplicas "
                         f"{maxr} < minReplicas {minr}")
    labels = _labels(name, "autoscaler")
    return {f"{name}-engine-hpa.yaml": {
        "apiVersion": "autoscaling/v2",
        "kind": "HorizontalPodAutoscaler",
        "metadata": {
            "name": f"kgct-{name}-engine-hpa",
            "labels": labels,
            "annotations": {
                # The prometheus-adapter rules an operator installs to
                # feed these Pods metrics — rendered here so the HPA
                # document carries its own wiring recipe.
                "kgct.io/adapter-rule-queue-wait": (
                    "kgct_queue_wait_seconds_p90 = histogram_quantile("
                    "0.9, sum by (pod, le) "
                    "(rate(kgct_queue_wait_seconds_bucket[2m])))"),
                "kgct.io/adapter-rule-shed-rate": (
                    "kgct_requests_shed_per_second = sum by (pod) "
                    "(rate(kgct_requests_shed_total[1m]))"),
                "kgct.io/slo-guardrail": (
                    "alert on kgct_slo_ttft_attainment_ratio < 0.9 — it "
                    "falls under load (inverse of HPA direction), so it "
                    "guards the scaler instead of driving it"),
            },
        },
        "spec": {
            "scaleTargetRef": {"apiVersion": "apps/v1",
                               "kind": "Deployment",
                               "name": f"kgct-{name}-engine"},
            "minReplicas": minr,
            "maxReplicas": maxr,
            "metrics": [
                {"type": "Pods", "pods": {
                    "metric": {"name": "kgct_queue_wait_seconds_p90"},
                    "target": {"type": "AverageValue",
                               "averageValue": _quantity(
                                   auto.get("targetQueueWaitSeconds",
                                            0.5))}}},
                {"type": "Pods", "pods": {
                    "metric": {"name": "kgct_requests_shed_per_second"},
                    "target": {"type": "AverageValue",
                               "averageValue": _quantity(
                                   auto.get("targetShedPerSecond",
                                            0.1))}}},
            ],
            # Shed-rate spikes scale up immediately; scale-down waits out
            # a stabilization window so a lull does not flap the fleet
            # (every scale event drains pods through the SIGTERM
            # drain/admission machinery).
            "behavior": {
                "scaleUp": {"stabilizationWindowSeconds": 0},
                "scaleDown": {"stabilizationWindowSeconds": int(
                    auto.get("scaleDownStabilizationSeconds", 300))},
            },
        },
    }}


# Architecture families the shared decoder graph serves (models/llama.py +
# config/model_config.py flags); hub-id basenames are matched by substring.
SUPPORTED_FAMILIES = ("llama", "qwen", "mixtral", "opt")


def _validate_model_url(spec: dict) -> None:
    """Fail the RENDER, not the pod, on an unservable modelURL (VERDICT r4
    missing #1/#2). Absolute paths are the pre-staged-weights story (the
    reference's hostPath local-model recipe, old_README.md:1482-1561) and
    pass through; anything else must map to a supported architecture preset
    — an unknown hub id would otherwise render a pod that crash-loops at
    start. A known preset WITHOUT a mounted weights volume still renders
    (CI smoke / random-init), with a loud warning that real serving needs
    pre-staged weights."""
    name = spec["name"]
    url = str(spec.get("modelURL") or "")
    if not url:
        raise ValueError(f"modelSpec '{name}': missing modelURL")
    if os.path.isabs(url):
        return
    if os.path.isdir(url) and os.path.exists(os.path.join(url, "config.json")):
        return   # relative local checkpoint dir: serves real weights
    from ..config.model_config import get_model_config
    try:
        get_model_config(url)
    except KeyError:
        base = url.rsplit("/", 1)[-1].lower()
        if not any(fam in base for fam in SUPPORTED_FAMILIES):
            raise ValueError(
                f"modelSpec '{name}': modelURL {url!r} is not in a supported "
                f"architecture family "
                f"({', '.join(sorted(SUPPORTED_FAMILIES))}). Serve it by "
                "pre-staging the checkpoint on the node and setting modelURL "
                "to its absolute path (mounted via extraVolumes), or pick a "
                "supported family.") from None
        logger.warning(
            "modelSpec '%s': modelURL %r is a supported family but not a "
            "built-in preset — the pod can only serve it from a PRE-STAGED "
            "checkpoint: set modelURL to the absolute checkpoint path "
            "(mounted via extraVolumes). As rendered, the server will exit "
            "at start with this guidance.", name, url)
        return
    # A hub-id modelURL (not a local checkpoint dir) never loads real
    # weights, regardless of mounted volumes — warn unconditionally.
    logger.warning(
        "modelSpec '%s': modelURL %r is a hub id — the pod will serve "
        "RANDOM-INIT weights (smoke/bench mode). For real serving, "
        "pre-stage the checkpoint on the node and set modelURL to its "
        "absolute path (mounted via extraVolumes).", name, url)


def render_values(values: dict) -> dict[str, dict]:
    """values dict (reference schema) -> {filename: k8s manifest dict}."""
    engine_spec = values.get("servingEngineSpec") or {}
    specs = engine_spec.get("modelSpec") or []
    if not specs:
        raise ValueError("servingEngineSpec.modelSpec is empty")
    engine = {
        "image": engine_spec.get("image", DEFAULT_IMAGE),
        "runtimeClassName": engine_spec.get("runtimeClassName") or None,
    }
    # Routing policy knobs: routerSpec is the natural home (the router owns
    # the policy); vllmConfig.routingPolicy is the values-schema-compatible
    # spelling (the reference kept every serving knob under vllmConfig) and
    # is honored on ANY modelSpec — there is one router, so two specs
    # naming different policies is a contradiction that fails the RENDER,
    # as does an unknown policy anywhere (never the router pod at start).
    router_spec = values.get("routerSpec") or {}
    spec_policies = {p for p in
                     ((s.get("vllmConfig") or {}).get("routingPolicy")
                      for s in specs) if p is not None}
    for policy in spec_policies | {router_spec.get("routingPolicy")}:
        if policy not in (None, "least-inflight", "prefix-affinity"):
            raise ValueError(
                f"routingPolicy {policy!r} is not a known policy "
                "(known: least-inflight, prefix-affinity)")
    if len(spec_policies) > 1:
        raise ValueError(
            "conflicting vllmConfig.routingPolicy values across modelSpec "
            f"entries ({', '.join(sorted(spec_policies))}): the stack has "
            "ONE router — set the policy once (routerSpec.routingPolicy)")
    router_policy = router_spec.get("routingPolicy")
    if (router_policy and spec_policies
            and spec_policies != {router_policy}):
        # Same contradiction, spelled across layers: silently letting one
        # side win would deploy a router the OTHER side believes is
        # cache-affine (or believes is not).
        raise ValueError(
            f"routerSpec.routingPolicy {router_policy!r} contradicts "
            f"vllmConfig.routingPolicy {spec_policies.pop()!r} — the stack "
            "has ONE router; set the policy in one place")
    cfg_knobs = [s.get("vllmConfig") or {} for s in specs]

    def knob(name):
        if router_spec.get(name) is not None:
            return router_spec[name]
        return next((c[name] for c in cfg_knobs
                     if c.get(name) is not None), None)

    routing = {
        "policy": (router_spec.get("routingPolicy")
                   or (spec_policies.pop() if spec_policies else None)),
        "affinityPrefixLen": knob("affinityPrefixLen"),
        "balanceFactor": knob("balanceFactor"),
    }
    # Multi-tenant QoS: the router must resolve tiers with the SAME table
    # the engines enforce, so the stack carries ONE table — conflicting
    # qosTiers across modelSpec entries (or vs routerSpec) fail the
    # render, like a conflicting routingPolicy would.
    qos_by_spec: dict[str, tuple] = {}
    for s in specs:
        q = _qos_tiers_arg(s.get("vllmConfig") or {},
                           f"modelSpec '{s.get('name', '?')}'")
        if q is not None:
            qos_by_spec[s.get("name", "?")] = q
    router_qos = _qos_tiers_arg(router_spec, "routerSpec")
    if len(set(qos_by_spec.values())) > 1:
        raise ValueError(
            "conflicting vllmConfig.qosTiers across modelSpec entries "
            f"({', '.join(sorted(qos_by_spec))}): the stack has ONE "
            "router resolving tiers — configure one table "
            "(routerSpec.qosTiers)")
    spec_qos = next(iter(qos_by_spec.values())) if qos_by_spec else None
    if (router_qos is not None and spec_qos is not None
            and router_qos != spec_qos):
        raise ValueError(
            "routerSpec.qosTiers contradicts vllmConfig.qosTiers — the "
            "router and the engines must resolve tiers identically; set "
            "the table in one place")
    routing["qos"] = router_qos or spec_qos
    affinity = routing["policy"] == "prefix-affinity"
    disagg_names = [s.get("name", "?") for s in specs if _disagg(s)]
    if disagg_names and len(specs) > 1:
        # The stack has ONE router and thus ONE prefill ring, while each
        # decode pod's --prefill-pool allowlist covers only its own spec's
        # prefill pods: a mixed stack would deterministically route a
        # fraction of handoffs to out-of-pool (or wrong-model) prefill
        # pods, silently degrading them to local recompute.
        raise ValueError(
            f"modelSpec(s) {disagg_names} use disaggregated prefill/decode "
            "in a multi-modelSpec stack — the router's single prefill ring "
            "cannot split across specs; render each disaggregated "
            "modelSpec as its own values file/stack")
    out: dict[str, dict] = {}
    replica_urls: list[str] = []
    prefill_urls: list[str] = []
    for spec in specs:
        if not spec.get("name"):
            raise ValueError("modelSpec entry missing 'name'")
        _validate_model_url(spec)
        out.update(_render_model(spec, engine, affinity=affinity))
        out.update(_render_hpa(spec, affinity))
        replica_urls.extend(_replica_urls(spec, affinity))
        prefill_urls.extend(_prefill_urls(spec))
    out.update(_render_router(replica_urls, router_spec, routing,
                              prefill_urls=prefill_urls))
    return out


def load_values_file(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def render_values_file(path: str) -> dict[str, dict]:
    return render_values(load_values_file(path))


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: python -m kubernetes_gpu_cluster_tpu_torch.deploy.render (or
    kgct-torch-render)
    -f values.yaml -o manifests/         (then: kubectl apply -f manifests/)
    -f values.yaml --emit-chart chart/   (then: helm install kgct chart/)"""
    p = argparse.ArgumentParser()
    p.add_argument("-f", "--values", required=True)
    p.add_argument("-o", "--out-dir", default=None,
                   help="write one YAML per manifest; default: print stream")
    p.add_argument("--emit-chart", metavar="DIR", default=None,
                   help="write an installable Helm chart (deploy/chart.py): "
                        "helm install/upgrade/rollback then manage releases")
    args = p.parse_args(argv)
    values = load_values_file(args.values)
    if args.emit_chart:
        from .chart import emit_chart
        files = emit_chart(values, args.emit_chart)
        print(f"wrote chart ({len(files)} files) to {args.emit_chart}")
        if not args.out_dir:
            return
    manifests = render_values(values)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for fname, manifest in sorted(manifests.items()):
            with open(os.path.join(args.out_dir, fname), "w") as f:
                yaml.safe_dump(manifest, f, sort_keys=False)
        print(f"wrote {len(manifests)} manifests to {args.out_dir}")
    else:
        docs = [yaml.safe_dump(m, sort_keys=False)
                for _, m in sorted(manifests.items())]
        print("---\n".join(docs), end="")


if __name__ == "__main__":
    main()

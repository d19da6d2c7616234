#!/usr/bin/env bash
# gpu_node_setup.sh — reset-first Kubernetes bootstrap for NVIDIA H100 nodes
# that run the PyTorch/CUDA port (kubernetes_gpu_cluster_tpu_torch).
#
# The counterpart of tpu_node_setup.sh, flag for flag and phase for phase:
# every invocation FIRST tears down any prior kubernetes state, then
# converges the node to a clean control-plane or worker join (the reference's
# k8s_setup.sh:375-424 recovery property). Phase 5 is the GPU's:
#   - detect_gpu reads nvidia-smi (count, product, driver version). It checks
#     the driver and never installs one: a driver is a download, installed
#     before this script runs.
#   - the node is labelled kgct.io/gpu=true, kgct.io/gpu-count and
#     kgct.io/gpu-product; the port's device plugin DaemonSet
#     (cluster/device-plugin-cuda/manifest/daemonset.yaml) selects on the
#     first and advertises nvidia.com/gpu, the resource the port's pods ask
#     for, handing each container the card's nodes and the driver's
#     libraries through Allocate: no NVIDIA container toolkit or OCI hook.
#   - CDI is enabled in containerd's config, and where the plugin binary is
#     installed (KGCT_CUDA_PLUGIN, default kgct-cuda-device-plugin on PATH)
#     its CDI spec is written to /etc/cdi/kgct-cuda.json, for containers run
#     outside the kubelet.
#
# Usage:
#   sudo bash gpu_node_setup.sh --yes --role=control_plane
#   sudo bash gpu_node_setup.sh --yes --role=node \
#       --join="$(ssh cp 'kubeadm token create --print-join-command')"
#   DRY_RUN=1 bash gpu_node_setup.sh --role=control_plane   # print, don't do
set -euo pipefail

# ---------------------------------------------------------------------------
# config + flags (reference parse_args k8s_setup.sh:22-47)
# ---------------------------------------------------------------------------
KUBE_VERSION="${KUBE_VERSION:-v1.33}"
CRI_SOCKET="${CRI_SOCKET:-unix:///run/containerd/containerd.sock}"
POD_CIDR="${POD_CIDR:-10.244.0.0/16}"
SERVICE_CIDR="${SERVICE_CIDR:-10.96.0.0/12}"
HTTP_PROXY_URL="${HTTP_PROXY_URL:-}"     # optional egress proxy (proxy_setup.sh)
# CNI: pinned Calico (the reference's choice, v3.28 — reference README.md:78,
# node-Ready gate journaled old_README.md:365-399). APPLY_CNI=0 to skip.
APPLY_CNI="${APPLY_CNI:-1}"
CALICO_VERSION="${CALICO_VERSION:-v3.28.0}"
CNI_MANIFEST="${CNI_MANIFEST:-https://raw.githubusercontent.com/projectcalico/calico/$CALICO_VERSION/manifests/calico.yaml}"
ROLE=""
JOIN_CMD=""
ASSUME_YES=0
DRY_RUN="${DRY_RUN:-0}"

log()  { echo -e "\e[32m[gpu-setup]\e[0m $*"; }
warn() { echo -e "\e[33m[gpu-setup]\e[0m $*" >&2; }
err()  { echo -e "\e[31m[gpu-setup]\e[0m $*" >&2; }

run() {  # every state-changing command goes through run() => DRY_RUN-able
  if [[ "$DRY_RUN" == "1" ]]; then echo "DRY: $*"; else "$@"; fi
}

usage() {
  grep '^#' "$0" | head -30; exit 1
}

for arg in "$@"; do
  case "$arg" in
    --yes) ASSUME_YES=1 ;;
    --role=*) ROLE="${arg#*=}" ;;
    --join=*) JOIN_CMD="${arg#*=}" ;;
    --kube-version=*) KUBE_VERSION="${arg#*=}" ;;
    --cri-socket=*) CRI_SOCKET="${arg#*=}" ;;
    --help|-h) usage ;;
    *) err "unknown flag: $arg"; usage ;;
  esac
done

require_root() {  # reference k8s_setup.sh:53-57
  if [[ "$DRY_RUN" != "1" && "$(id -u)" -ne 0 ]]; then
    err "must run as root (or DRY_RUN=1)"; exit 1
  fi
}

confirm() {  # destructive-op gate (reference k8s_setup.sh:59-63)
  [[ "$ASSUME_YES" == "1" || "$DRY_RUN" == "1" ]] && return 0
  read -r -p "$1 [y/N] " ans
  [[ "$ans" == "y" || "$ans" == "Y" ]]
}

# ---------------------------------------------------------------------------
# phase 1: teardown (reference k8s_setup.sh:375-392, :67-163)
# ---------------------------------------------------------------------------
teardown() {
  log "reset-first teardown"
  run systemctl stop kubelet 2>/dev/null || true
  run systemctl disable kubelet 2>/dev/null || true
  # kill any stray apiserver and free 6443 (reference :136-163)
  run pkill -9 -f kube-apiserver 2>/dev/null || true
  if command -v ss >/dev/null; then
    local pids
    pids=$(ss -lptn 'sport = :6443' 2>/dev/null \
           | grep -oP 'pid=\K[0-9]+' | sort -u || true)
    for p in $pids; do run kill -9 "$p" || true; done
  fi
  if confirm "remove /etc/kubernetes /var/lib/kubelet /var/lib/etcd ~/.kube?"; then
    run rm -rf /etc/kubernetes /var/lib/kubelet /var/lib/etcd \
        "${SUDO_USER:+/home/$SUDO_USER/.kube}" /root/.kube
  fi
  run kubeadm reset -f 2>/dev/null || true
}

# ---------------------------------------------------------------------------
# phase 2: host prereqs — swap + kernel networking
# (reference k8s_setup.sh:165-261)
# ---------------------------------------------------------------------------
disable_swap() {
  log "disabling swap (runtime + units + fstab)"
  run swapoff -a || true
  # mask systemd swap units (reference :218-231)
  for unit in $(systemctl list-unit-files --type swap --no-legend 2>/dev/null \
                | awk '{print $1}'); do
    run systemctl mask "$unit" || true
  done
  # comment swap lines out of fstab with a timestamped backup (reference :187-216)
  if [[ -f /etc/fstab ]] && grep -qE '^[^#].*\sswap\s' /etc/fstab; then
    local backup="/etc/fstab.kgct-$(date +%s).bak"
    run cp /etc/fstab "$backup"
    run sed -i -E 's@^([^#].*\sswap\s.*)@#\1@' /etc/fstab
    log "fstab swap entries commented (backup: $backup)"
  fi
}

setup_netfilter() {
  log "kernel networking prereqs (br_netfilter, forwarding)"
  run modprobe br_netfilter || true
  run modprobe overlay || true
  if [[ "$DRY_RUN" == "1" ]]; then
    echo "DRY: write /etc/modules-load.d/kgct-k8s.conf + sysctl"
    return
  fi
  cat > /etc/modules-load.d/kgct-k8s.conf <<EOF
br_netfilter
overlay
EOF
  cat > /etc/sysctl.d/99-kgct-k8s.conf <<EOF
net.bridge.bridge-nf-call-iptables  = 1
net.bridge.bridge-nf-call-ip6tables = 1
net.ipv4.ip_forward                 = 1
EOF
  sysctl --system >/dev/null
}

# ---------------------------------------------------------------------------
# phase 3: container runtime wiring (reference crio_setup.sh + k8s_setup.sh:291-316)
# ---------------------------------------------------------------------------
setup_runtime() {
  log "container runtime: containerd (systemd cgroups, proxy drop-in)"
  if ! command -v containerd >/dev/null && [[ "$DRY_RUN" != "1" ]]; then
    err "containerd not installed; run runtime_setup.sh first"; exit 1
  fi
  if [[ "$DRY_RUN" == "1" ]]; then
    echo "DRY: configure containerd (SystemdCgroup=true)"
    if [[ -n "$HTTP_PROXY_URL" ]]; then
      echo "DRY: containerd http-proxy.conf NO_PROXY=$(no_proxy_value)"
    fi
    return 0
  fi
  mkdir -p /etc/containerd
  if ! containerd config dump 2>/dev/null | grep -q "SystemdCgroup = true"; then
    containerd config default \
      | sed 's/SystemdCgroup = false/SystemdCgroup = true/' \
      > /etc/containerd/config.toml
  fi
  # proxy drop-in so IMAGE PULLS traverse the egress proxy with cluster CIDRs
  # excluded — the hard-won NO_PROXY fix (reference k8s_setup.sh:291-316,
  # journaled old_README.md:659-684)
  if [[ -n "$HTTP_PROXY_URL" ]]; then
    mkdir -p /etc/systemd/system/containerd.service.d
    cat > /etc/systemd/system/containerd.service.d/http-proxy.conf <<EOF
[Service]
Environment="HTTP_PROXY=$HTTP_PROXY_URL"
Environment="HTTPS_PROXY=$HTTP_PROXY_URL"
Environment="NO_PROXY=$(no_proxy_value)"
EOF
  fi
  systemctl daemon-reload
  systemctl enable --now containerd
  systemctl restart containerd
}

no_proxy_value() {  # single source of truth, visible to DRY_RUN golden tests
  echo "localhost,127.0.0.1,10.0.0.0/8,$POD_CIDR,$SERVICE_CIDR,.svc,.cluster.local"
}

# ---------------------------------------------------------------------------
# phase 4: kubeadm/kubelet/kubectl install, pinned + held
# (reference install_k8s_apt k8s_setup.sh:263-289)
# ---------------------------------------------------------------------------
install_k8s() {
  log "installing kubeadm/kubelet/kubectl $KUBE_VERSION (pinned, apt-held)"
  if [[ "$DRY_RUN" == "1" ]]; then echo "DRY: apt install kube* $KUBE_VERSION"; return; fi
  command -v kubeadm >/dev/null && { log "kubeadm present, skipping"; return; }
  local keyring=/etc/apt/keyrings/kubernetes-apt-keyring.gpg
  mkdir -p /etc/apt/keyrings
  local curl_cmd=(curl -fsSL)
  [[ -n "$HTTP_PROXY_URL" ]] && curl_cmd+=(--proxy "$HTTP_PROXY_URL")
  "${curl_cmd[@]}" "https://pkgs.k8s.io/core:/stable:/$KUBE_VERSION/deb/Release.key" \
    | gpg --dearmor -o "$keyring"
  echo "deb [signed-by=$keyring] https://pkgs.k8s.io/core:/stable:/$KUBE_VERSION/deb/ /" \
    > /etc/apt/sources.list.d/kubernetes.list
  apt-get update
  apt-get install -y kubelet kubeadm kubectl
  apt-mark hold kubelet kubeadm kubectl
  systemctl enable kubelet
}

# ---------------------------------------------------------------------------
# phase 5: GPU enablement — check the driver, label the node, enable CDI
# (the reference's NVIDIA chain gpu-crio-setup.sh:58-126, without the
#  container toolkit: the device plugin's Allocate injects what it did)
# ---------------------------------------------------------------------------
NVIDIA_SMI="${NVIDIA_SMI:-nvidia-smi}"
KGCT_CUDA_PLUGIN="${KGCT_CUDA_PLUGIN:-kgct-cuda-device-plugin}"
CDI_SPEC="${CDI_SPEC:-/etc/cdi/kgct-cuda.json}"
GPU_DAEMONSET="cluster/device-plugin-cuda/manifest/daemonset.yaml"

detect_gpu() {  # read-only: runs under DRY_RUN too
  log "detecting NVIDIA GPUs"
  GPU_COUNT=0; GPU_PRODUCT="none"; GPU_DRIVER="none"
  if ! command -v "$NVIDIA_SMI" >/dev/null; then
    warn "no NVIDIA driver ($NVIDIA_SMI not found): this node advertises no GPU"
    warn "  install the driver first; this script never installs one"
    return 0
  fi
  local out
  if ! out=$("$NVIDIA_SMI" --query-gpu=name,driver_version \
               --format=csv,noheader); then
    err "$NVIDIA_SMI failed: the driver is installed but not working"
    exit 1
  fi
  GPU_COUNT=$(grep -c . <<<"$out" || true)
  GPU_PRODUCT=$(head -n1 <<<"$out" | cut -d, -f1 | sed 's/^ *//; s/ *$//; s/ /-/g')
  GPU_DRIVER=$(head -n1 <<<"$out" | cut -d, -f2 | tr -d ' ')
  log "GPU: count=$GPU_COUNT product=$GPU_PRODUCT driver=$GPU_DRIVER"
}

label_node() {  # the DaemonSet's nodeSelector and scheduling labels
  local node="$1"
  [[ "$GPU_COUNT" == "0" ]] && { warn "no GPUs; skipping labels"; return; }
  run kubectl label node "$node" --overwrite \
    "kgct.io/gpu=true" \
    "kgct.io/gpu-count=$GPU_COUNT" \
    "kgct.io/gpu-product=$GPU_PRODUCT"
}

enable_cdi() {  # containerd 1.7 reads CDI specs only with enable_cdi = true
  [[ "$GPU_COUNT" == "0" ]] && return 0
  local conf=/etc/containerd/config.toml
  local skip="the DaemonSet's Allocate needs no CDI"
  if [[ "$CRI_SOCKET" != *containerd* ]]; then
    warn "CDI not enabled: $CRI_SOCKET is not containerd's; enable CDI in that runtime's own config ($skip)"
  elif [[ "$DRY_RUN" == "1" ]]; then
    log "enabling CDI in containerd (specs in /etc/cdi, /var/run/cdi)"
    echo "DRY: containerd config: enable_cdi = true, cdi_spec_dirs = [/etc/cdi, /var/run/cdi]"
  elif grep -q 'enable_cdi = false' "$conf" 2>/dev/null; then
    log "enabling CDI in containerd (specs in /etc/cdi, /var/run/cdi)"
    sed -i 's/enable_cdi = false/enable_cdi = true/' "$conf"
    systemctl restart containerd
  elif grep -q 'enable_cdi = true' "$conf" 2>/dev/null; then
    log "CDI already enabled in containerd"
  else
    warn "CDI not enabled: $conf has no enable_cdi key; set enable_cdi = true under its CRI plugin's section ($skip)"
  fi
  if command -v "$KGCT_CUDA_PLUGIN" >/dev/null; then
    run mkdir -p "$(dirname "$CDI_SPEC")"
    run "$KGCT_CUDA_PLUGIN" --write-cdi-spec="$CDI_SPEC"
  else
    log "$KGCT_CUDA_PLUGIN not installed: no CDI spec written (the DaemonSet's Allocate needs none)"
  fi
}

# ---------------------------------------------------------------------------
# phase 6: init / join (reference init_control_plane k8s_setup.sh:336-361,
#                       join_node :363-372)
# ---------------------------------------------------------------------------
init_control_plane() {
  log "kubeadm init (control plane)"
  local logf="/var/log/kgct-kubeadm-init-$(date +%s).log"
  [[ "$DRY_RUN" == "1" ]] && logf=/dev/null   # a dry run writes no log
  local extra=()
  [[ -n "${CONTROL_PLANE_ENDPOINT:-}" ]] && \
    extra+=(--control-plane-endpoint "$CONTROL_PLANE_ENDPOINT" --upload-certs)
  run kubeadm init \
    --cri-socket="$CRI_SOCKET" \
    --pod-network-cidr="$POD_CIDR" \
    "${extra[@]}" 2>&1 | tee "$logf"
  # success heuristic: the join hint must be in the log (reference :354-359)
  if [[ "$DRY_RUN" != "1" ]] && ! grep -q 'kubeadm join .* --token' "$logf"; then
    err "kubeadm init did not produce a join command — see $logf"; exit 1
  fi
  post_init_kubeconfig
  detect_gpu
  label_node "$(hostname | tr '[:upper:]' '[:lower:]')" || true
  enable_cdi
  apply_cni
  fix_coredns
  log "control plane up. Next:"
  log "  kubectl apply -f $GPU_DAEMONSET"
}

fix_coredns() {  # C30-class cluster hardening (reference old_README.md:780-850:
                 # CoreDNS health port clash + GODEBUG): move the health probe
                 # off :8181 when the host already binds it. Gated, optional.
  [[ "${FIX_COREDNS:-0}" != "1" ]] && return 0
  log "patching CoreDNS health port 8181 -> 8182 (reference failure mode)"
  if [[ "$DRY_RUN" == "1" ]]; then
    echo "DRY: kubectl -n kube-system patch configmap coredns (health :8182)"
    echo "DRY: kubectl -n kube-system rollout restart deployment coredns"
    return 0
  fi
  kubectl -n kube-system get configmap coredns -o yaml \
    | sed 's/health {/health :8182 {/; s/^\(\s*\)health$/\1health :8182/' \
    | kubectl apply -f -
  kubectl -n kube-system rollout restart deployment coredns
}

apply_cni() {  # pinned CNI + node-Ready gate (reference README.md:78,
               # watch flow old_README.md:365-399; was a manual step there)
  if [[ "$APPLY_CNI" != "1" ]]; then
    log "APPLY_CNI=0: skipping CNI; apply one for $POD_CIDR before joining nodes"
    return
  fi
  log "applying CNI: $CNI_MANIFEST"
  run kubectl apply -f "$CNI_MANIFEST"
  [[ "$DRY_RUN" == "1" ]] && { echo "DRY: wait for node Ready"; return; }
  log "waiting for node Ready (CNI up)"
  if ! kubectl wait --for=condition=Ready node --all --timeout=300s; then
    warn "node not Ready after 300s — inspect CNI pods:"
    warn "  kubectl get pods -n kube-system -o wide"
    return 1
  fi
  log "node Ready"
}

post_init_kubeconfig() {  # reference k8s_setup.sh:320-334
  [[ "$DRY_RUN" == "1" ]] && { echo "DRY: install kubeconfig"; return; }
  local target_user="${SUDO_USER:-root}"
  local home_dir; home_dir=$(eval echo "~$target_user")
  mkdir -p "$home_dir/.kube"
  cp -f /etc/kubernetes/admin.conf "$home_dir/.kube/config"
  chown "$(id -u "$target_user")":"$(id -g "$target_user")" "$home_dir/.kube/config"
}

join_node() {
  [[ -z "$JOIN_CMD" ]] && { err "--role=node requires --join=..."; exit 1; }
  # auto-append the CRI socket (reference k8s_setup.sh:41-44)
  [[ "$JOIN_CMD" != *"--cri-socket"* ]] && JOIN_CMD="$JOIN_CMD --cri-socket=$CRI_SOCKET"
  log "joining cluster"
  run bash -c "$JOIN_CMD"
  detect_gpu
  enable_cdi
  [[ "$GPU_COUNT" == "0" ]] && { log "joined (no GPU: nothing to label)"; return; }
  log "joined. Label from the control plane (the DaemonSet then starts here):"
  log "  kubectl label node $(hostname | tr '[:upper:]' '[:lower:]') kgct.io/gpu=true kgct.io/gpu-count=$GPU_COUNT kgct.io/gpu-product=$GPU_PRODUCT"
  log "  kubectl apply -f $GPU_DAEMONSET   # once per cluster"
}

# ---------------------------------------------------------------------------
# main (reference main() k8s_setup.sh:375-424: teardown ALWAYS runs; the role
# only gates the final step)
# ---------------------------------------------------------------------------
main() {
  require_root
  teardown
  disable_swap
  setup_netfilter
  setup_runtime
  install_k8s
  case "$ROLE" in
    control_plane) init_control_plane ;;
    node) join_node ;;
    "") log "no --role given: node reset + prereqs done (re-runnable)" ;;
    *) err "unknown --role=$ROLE (control_plane|node)"; exit 1 ;;
  esac
}
main

#!/usr/bin/env bash
# Start one of the PyTorch port's camera servers on each remote capture
# host over ssh: the port's counterpart of scripts/start_cameras.sh.
# Hosts come from a file (one "user@host[:port]" per line). Each host
# needs the port installed (pip install '.[torch]'), or a checkout of this
# repository at REPO_DIR, which the server then runs from. The servers
# listen on every interface unless the extra args give --host.
#
# Usage: scripts/start_cameras_torch.sh hosts.txt [extra fake_server args...]
set -euo pipefail

HOSTS_FILE="${1:?usage: start_cameras_torch.sh hosts.txt [args...]}"
shift || true
EXTRA_ARGS=("$@")
REPO_DIR="${REPO_DIR:-}"

i=0
while IFS= read -r line; do
  [[ -z "$line" || "$line" == \#* ]] && continue
  host="${line%%:*}"
  port="${line#*:}"; [[ "$port" == "$host" ]] && port=8000
  echo "starting camera server $i on $host:$port"
  ssh -o BatchMode=yes "$host" \
    "${REPO_DIR:+cd $REPO_DIR || exit 1;} nohup python -m \
       pointcloud_stitching_tpu_torch.runtime.fake_server \
       --host 0.0.0.0 --port $port ${EXTRA_ARGS[*]:-} \
       > \${TMPDIR:-/tmp}/pcs-torch-camera-$i.log 2>&1 &" &
  i=$((i+1))
done < "$HOSTS_FILE"
wait
echo "started $i camera servers"

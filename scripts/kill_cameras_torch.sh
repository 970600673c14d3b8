#!/usr/bin/env bash
# Kill the PyTorch port's camera servers on all capture hosts: the port's
# counterpart of scripts/kill_cameras.sh. The pattern matches the port's
# server module and not the JAX package's.
#
# Usage: scripts/kill_cameras_torch.sh hosts.txt
set -euo pipefail

PATTERN='pointcloud_stitching_tpu_torch[.]runtime[.]fake_server'

HOSTS_FILE="${1:?usage: kill_cameras_torch.sh hosts.txt}"
while IFS= read -r line; do
  [[ -z "$line" || "$line" == \#* ]] && continue
  host="${line%%:*}"
  echo "killing camera servers on $host"
  ssh -o BatchMode=yes "$host" "pkill -f '$PATTERN' || true" &
done < "$HOSTS_FILE"
wait

#!/bin/bash
# Multi-host EPS launcher — the analog of the reference's SLURM
# scripts (hpc/run-helios.sh): one solver process per host or card,
# cooperating over jax.distributed (bound sharing + deterministic work
# stealing, turbo_tpu/parallel/multihost.py).
#
# On a cluster, run the SAME command on every host with its index:
#
#   TURBO_TPU_COORDINATOR=host0:8476 TURBO_TPU_HOSTS=4 \
#   TURBO_TPU_HOST_ID=$(hostname_index) \
#     python -m turbo_tpu.cli model.fzn -s -t 60000
#
# On one machine it runs N processes on localhost:
#
#   scripts/run_multihost.sh [-n HOSTS] [-gpu] model.fzn [solver flags...]
#
# Without -gpu each process runs on the CPU platform with 2 virtual
# devices. With -gpu process i gets card i alone (CUDA_VISIBLE_DEVICES),
# since a JAX process reserves most of the memory of every card it opens.
set -euo pipefail
cd "$(dirname "$0")/.."

HOSTS=2
GPU=0
if [ "${1:-}" = "-n" ]; then HOSTS=$2; shift 2; fi
if [ "${1:-}" = "-gpu" ]; then GPU=1; shift; fi
MODEL=$1; shift
PORT=$(( 20000 + RANDOM % 20000 ))

pids=()
for ((i=0; i<HOSTS; i++)); do
  if [ "$GPU" = 1 ]; then
    CUDA_VISIBLE_DEVICES=$i \
    TURBO_TPU_COORDINATOR="localhost:$PORT" \
    TURBO_TPU_HOSTS=$HOSTS TURBO_TPU_HOST_ID=$i \
      python -m turbo_tpu.cli "$MODEL" "$@" &
  else
    XLA_FLAGS="--xla_force_host_platform_device_count=2" \
    TURBO_TPU_COORDINATOR="localhost:$PORT" \
    TURBO_TPU_HOSTS=$HOSTS TURBO_TPU_HOST_ID=$i \
      python -m turbo_tpu.cli "$MODEL" -platform cpu "$@" &
  fi
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do wait "$p" || rc=$?; done
exit $rc

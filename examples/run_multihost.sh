#!/usr/bin/env bash
# Multi-process run of ONE large FASTA across several GPU hosts.
#
# Launch this script once per process (SLURM srun, mpirun, or any
# process launcher).  Each process needs the standard jax.distributed
# triplet:
#
#   JAX_COORDINATOR_ADDRESS=<host0>:<port>
#   JAX_NUM_PROCESSES=<n>
#   JAX_PROCESS_ID=<0..n-1>
#
# (Under SLURM or Open MPI jax auto-detects all three.)  To run one
# process per card on a multi-GPU host, also set LOCAL_RANK=<index of
# the card on its host>: each process then opens only that card (a JAX
# process reserves most of every card it opens).
#
# With a single plain-FASTA input, --distributed shards the FILE by
# record-aligned byte ranges: every host streams only its slice, and
# process 0 merges the per-host parts into the final output
# (byte-identical to a single-host run — splicing .cfrk rows for
# per-read mode, summing tables for spectrum, unique-merging sparse
# keys).  Each process additionally auto-meshes over its own local cards
# (--devices 1 to opt out).
set -euo pipefail
INPUT=${1:?usage: run_multihost.sh <big.fasta> <out.cfrk> [k]}
OUT=${2:?}
K=${3:-8}

python -m cfrk_tpu "$INPUT" -k "$K" -o "$OUT" \
    --distributed --stream --stats

#!/usr/bin/env bash
# The port's devnet, the twin of scripts/launch-devnet.sh: bridge service,
# gRPC prover, CL driver and node, all of eigen_zeth_tpu_torch.
#
# Process 1: the bridge HTTP service (settlement/bridge_mock.py), the custom
#            settlement's REST backend (/sequence-batches, /verify-batches,
#            exit roots ...).
# Process 2: `python -m eigen_zeth_tpu_torch prover --device $DEVICE`,
#            serving prover.v1.ProverService against the node's L2 RPC and
#            proving on the card (DEVICE=cpu for a check without one, with
#            STARK_PROFILE=test and FINAL_WRAP=linear to keep it short).
# Process 3: the CL driver (sequencer/cl_driver.py), producing blocks
#            through the engine API (forkchoiceUpdatedV3 / getPayloadV3 /
#            newPayloadV3) every SLOT_SECONDS; SLOT_SECONDS=0 falls back to
#            auto-mine.
# Process 4: `python -m eigen_zeth_tpu_torch run --settlement custom
#            --database $DATABASE --prover-addr ...`, the node, settling
#            through process 1 and proving through process 2; the node
#            itself does no device work.
set -euo pipefail
cd "$(dirname "$0")/.."

RPC_PORT=${RPC_PORT:-8546}
PROVER_PORT=${PROVER_PORT:-50061}
BRIDGE_PORT=${BRIDGE_PORT:-8001}
STARK_PROFILE=${STARK_PROFILE:-production}
FINAL_WRAP=${FINAL_WRAP:-stark}
DEVICE=${DEVICE:-cuda}
DATABASE=${DATABASE:-native}
DB_PATH=${DB_PATH:-tmp/devnet-torch/zeth.db}
SLOT_SECONDS=${SLOT_SECONDS:-2}

python -m eigen_zeth_tpu_torch.settlement.bridge_mock --port "$BRIDGE_PORT" &
BRIDGE_PID=$!

python -m eigen_zeth_tpu_torch prover \
  --port "$PROVER_PORT" \
  --l2-addr "http://127.0.0.1:${RPC_PORT}" \
  --stark-profile "$STARK_PROFILE" \
  --final-wrap "$FINAL_WRAP" \
  --device "$DEVICE" &
PROVER_PID=$!

CL_PID=""
AUTO_MINE_ARGS=(--auto-mine-interval 2.0)
if [ "$SLOT_SECONDS" != "0" ]; then
  ( sleep 5; exec python -m eigen_zeth_tpu_torch.sequencer.cl_driver \
      --el "http://127.0.0.1:${RPC_PORT}" --slot "$SLOT_SECONDS" ) &
  CL_PID=$!
  AUTO_MINE_ARGS=(--auto-mine-interval 0)
fi
trap 'kill $PROVER_PID $BRIDGE_PID $CL_PID 2>/dev/null || true' EXIT

# give the services a moment to bind
sleep 2

BRIDGE_SERVICE_ADDR="http://127.0.0.1:${BRIDGE_PORT}" \
python -m eigen_zeth_tpu_torch run \
  --dev-fund \
  --database "$DATABASE" \
  --db-path "$DB_PATH" \
  --settlement custom \
  --rpc-port "$RPC_PORT" \
  "${AUTO_MINE_ARGS[@]}" \
  --prover-addr "http://127.0.0.1:${PROVER_PORT}" \
  "$@"

#!/bin/bash
# The port's quality recipe, tools/run_quality.sh for dgmesh_torch on one
# GPU: synthetic GT-mesh dataset -> training -> run_testing metrics ->
# 200-frame mesh export -> CD/EMD against the exact GT surfaces.  Results
# land in $RUN; `python tools/make_quality_md.py --run "$RUN"` summarises
# them.  Run again after an interruption, it resumes from the run's latest
# checkpoint; `python -m dgmesh_torch.cli.evaluate -m "$RUN" -s "$DS"` gives
# the quality numbers of a checkpoint without training on.
set -e
cd "$(dirname "$0")/.."

DS=${DS:-output/quality_ds}
RUN=${RUN:-output/quality_run}
CFG=${CFG:-configs/synthetic-quality-full.yaml}

if [ ! -f "$DS/transforms_train.json" ]; then
  python - <<PY
from dgmesh_torch.data.synthetic_mesh import generate_mesh_dataset
generate_mesh_dataset("$DS", n_frames=40, width=800, height=800, n_test=8,
                      subdiv=5, n_eval_meshes=200)
PY
fi

RESUME=()
if ls "$RUN"/checkpoint/state_*.pt >/dev/null 2>&1; then
  RESUME=(--start_checkpoint "$RUN")
fi
python -m dgmesh_torch.cli.train --config "$CFG" -s "$DS" -m "$RUN" \
    --pretrain_mesh_path "$DS/mesh" --pretrain_mesh_path_test "$DS/mesh_test" \
    --export_meshes 200 --log_images \
    --save_iterations 2000 4000 6000 8000 10000 "${RESUME[@]}"

python -m dgmesh_torch.cli.mesh_evaluation --gt_dir "$DS/gt_eval" \
    --pred_dir "$RUN/meshes" --transforms "$DS/transforms_train.json" \
    --out "$RUN/eval_results.txt"

echo "=== test_result.txt ==="; cat "$RUN/test_results/test_result.txt"
echo "=== eval_results tail ==="; tail -3 "$RUN/eval_results.txt"

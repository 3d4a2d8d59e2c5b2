"""The port's command-line entry points (reference train.py, render_test.py,
render_trajectory.py, mesh_evaluation.py; the JAX package's
tools/eval_from_checkpoint.py):

    python -m dgmesh_torch.cli.train --config CONFIG.yaml -s DATA -m OUT [--export_meshes N]
    python -m dgmesh_torch.cli.render_test -m OUT
    python -m dgmesh_torch.cli.render_trajectory -m OUT [--n_views N]
    python -m dgmesh_torch.cli.mesh_evaluation --gt_dir DATA/gt_eval --pred_dir OUT/meshes
    python -m dgmesh_torch.cli.evaluate -m OUT -s DATA [--iteration N] [--n_meshes N] [--skip_cd]

Each runs on ``cuda`` unless ``--device`` asks for another device, and
raises on a machine without a GPU otherwise.  tools/torch_run_quality.sh
chains the dataset, ``train`` and ``mesh_evaluation`` into the quality
recipe.
"""

"""The port's command-line entry points (reference train.py, render_test.py):

    python -m dgmesh_torch.cli.train --config CONFIG.yaml -s DATA -m OUT
    python -m dgmesh_torch.cli.render_test -m OUT

Each runs on ``cuda`` unless ``--device`` asks for another device, and
raises on a machine without a GPU otherwise.
"""

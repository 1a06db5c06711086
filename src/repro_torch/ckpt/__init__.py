# The port of repro.ckpt: checkpoints with lattice manifests, in the
# reference's on-disk format.
from .checkpoint import (Manifest, assign_sequential, is_complete,
                         latest_manifest, merge_manifests, restore, save)

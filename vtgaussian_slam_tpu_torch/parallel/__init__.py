"""Multi-GPU: the SLAM loops and the generic render sharded over image
tiles across the ranks of a `torch.distributed` process group."""
from .engine import (init_process_group, make_map_frame_binned_sharded,
                     make_mesh, make_track_frame_cached_sharded, tile_pad_for)
from .sharded import (sharded_mapping_step, sharded_render,
                      sharded_tracking_step)

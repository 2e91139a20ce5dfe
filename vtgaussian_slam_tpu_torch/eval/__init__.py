from .evaluate import eval_recon, eval_sequence
from .mesh import accuracy_completion, calc_2d_metric, render_mesh_depth
from .metrics import align_horn, calc_psnr, evaluate_ate
from .plyio import read_ply, write_ply

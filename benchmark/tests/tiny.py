"""Tiny geometries of the benchmark's configurations for the CPU tests:
the cells' own flags with the widths, depths and lengths cut down."""
from wbench.spec import load_cell

TINY = ["--dim", "32", "--s_patch_size", "8", "--s_latent_shape", "4,8",
        "--s_embed_dim", "64", "--s_num_heads", "4", "--s_num_obj", "4", "--s_oe_depth", "1",
        "--s_pe_depth", "1", "--s_pg_com_depth", "1", "--s_pg_enc_depth", "1",
        "--s_pg_dec_depth", "1", "--s_pg_num_timesteps", "5", "--s_oe_num_timesteps", "5",
        "--s_ii_depth", "2", "--s_ii_embed_dim", "32", "--s_ctx_len", "2", "--data.vid_len", "5"]


def tiny_cell(workload: str, batch: int = 2):
    """The cell as BENCHMARK.json defines it, at a tiny size, with two
    batches in its pool and its limits as the benchmark sets them."""
    cell = load_cell(workload)
    extra = list(TINY)
    if cell.config_name == "kitti":
        extra += ["--s_latent_shape", "4,13"]
    if cell.traffic["loop"] == "eval":
        extra += ["--load_dim", "64", "--flow_dim", "32", "--batch_size_vid", "1"]
    else:
        extra += ["--batch_size_vid", str(batch)]
    cell.config["changed"] = list(cell.config.get("changed", [])) + extra
    cell.traffic["pool"] = 2
    return cell

from deepfbsdejsolvers_torch.parallel.data_parallel import (
    make_dp_epoch,
    make_dp_loss,
    make_dp_update,
    make_mesh,
    per_shard_batch,
)

__all__ = ["make_mesh", "make_dp_loss", "make_dp_update", "make_dp_epoch",
           "per_shard_batch"]

"""Raw event-camera decoders, the DSEC slicer and the host augmentations:
the port's own copy of mem_tpu/events (numpy only, no jax)."""
from mem_tpu_torch.events.decoders import (
    decode_atis_bytes,
    decode_ncars_bytes,
    decode_ncaltech101_file,
    decode_ncars_file,
    decode_nimagenet_file,
)
from mem_tpu_torch.events.augment import (
    slice_random_max_evs,
    random_time_flip,
    flip_events_x,
    random_shift_events,
    reshape_scale_xy,
)

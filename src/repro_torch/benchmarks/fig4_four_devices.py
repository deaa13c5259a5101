"""Paper Fig. 4: policy comparison with four computation devices (Fig. 2's
rows at M = 4).  Accepts the same ``--engine {event,batched}`` flag as
Fig. 2."""

from __future__ import annotations

from . import fig2_single_device
from .common import parse_engine_args


def main(device=None) -> None:
    args = parse_engine_args()
    fig2_single_device.run(num_devices=4, tag="fig4", engine=args.engine,
                           num_seeds=args.seeds, device=device)


if __name__ == "__main__":
    main()

"""Layer: the device, in the Wan cell. Share of the traced window in which no kernel, copy or fill runs
on the card, in percent: ``idle_share.sample``'s reading."""

from benchmark import manifest as mf

read = mf.metric_reader("idle_share.sample")

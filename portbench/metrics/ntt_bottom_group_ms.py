"""ntt_bottom_group_ms: device ms a transform spends in its bottom stage
group: the program's ``ntt.stage_group`` span with ``include_low`` (the
group with the five in-word stages)."""

from portbench import program_spans

program_spans.arm()


def read(win):
    return program_spans.program_ms(
        win, "ntt.stage_group", where=lambda attrs: attrs.get("include_low"))

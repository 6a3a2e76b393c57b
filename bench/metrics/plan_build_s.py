"""Seconds in the program's ``plan.build`` spans (repro_torch.obs, the
process recorder): the planner's share of set-up."""


def read(view):
    rec = view.program_recorder
    q = rec.quantiles("plan.build") if rec is not None else None
    return None if q is None else q["total"]

"""Steps of the training window run as eager single steps (the feed's
leftovers, which form no K-stack), over all its steps, in %."""


def read(r):
    if r["kind"] != "train" or not r["steps"]:
        return None
    return 100.0 * r["singles"] / r["steps"]

"""Mean solver iterations of each window leg's winning lane (the
document's ``iterations``)."""


def read(rec):
    if rec["kind"] != "mission_legs" or not rec["requests"]:
        return None
    return sum(r["iterations"] for r in rec["requests"]) / len(rec["requests"])

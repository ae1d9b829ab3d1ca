"""Score + seen mask + top-K for a batch of users over every item.

Reads the item table and the batch's user rows once, the padded seen ids
(int32) and their mask (one byte each), and writes k (score, id) pairs
per user; a multiply-add per user, item and column.
"""
OP = "fused_topk_score"


def describe(ue, table, seen, seen_mask, *, k, n_items, item_block=1024,
             impl=None):
    key = (int(ue.shape[0]), int(ue.shape[1]), int(n_items),
           int(seen.shape[1]), int(k))
    return key, key


def work(payload):
    b, d, n_items, w, k = payload
    nbytes = n_items * d * 4 + b * d * 4 + b * w * 5 + b * k * 8
    return 2.0 * b * n_items * d, float(nbytes)

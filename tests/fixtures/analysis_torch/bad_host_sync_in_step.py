"""Seeded violation: host-sync-in-step (a per-step read on the host)."""


def make_train_step(lr):
    def step(theta, grad):
        theta = theta - lr * grad
        loss = grad.pow(2).sum().item()   # BAD: waits for the card per step
        return theta, loss
    return step

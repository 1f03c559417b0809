"""Clean counterpart: the step keeps its metric on the device; the loop
drains it once, outside the step."""
import torch


def make_train_step(lr):
    def step(theta, grad):
        return theta - lr * grad, grad.pow(2).sum()
    return step


def train(theta, grads, lr):
    step = make_train_step(lr)
    losses = []
    for g in grads:
        theta, loss = step(theta, g)
        losses.append(loss)
    return theta, torch.stack(losses).cpu()

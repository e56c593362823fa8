"""Models of the port."""
from .bert import (BertConfig, BertForPretraining, BertForQuestionAnswering,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_tiny)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_small, gpt_tiny
from .wide_deep import WideDeep, wide_deep_tiny

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_small", "BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertForQuestionAnswering",
           "bert_base", "bert_tiny", "WideDeep", "wide_deep_tiny"]

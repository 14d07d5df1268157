"""Expression DSL surface of the port (the analog of pyspark.sql.functions)."""
from spark_rapids_tpu_torch.expressions.core import (
    Alias,
    BoundReference,
    Col,
    EvalContext,
    Expression,
    Literal,
    col,
    lit,
)
from spark_rapids_tpu_torch.expressions.arithmetic import (Add, Divide,
                                                        Multiply, Subtract)
from spark_rapids_tpu_torch.expressions.predicates import (
    And,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    IsNull,
    LessThan,
    LessThanOrEqual,
    Not,
    Or,
)
from spark_rapids_tpu_torch.expressions.strings import Substring
from spark_rapids_tpu_torch.expressions.casts import Cast
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.aggregates import (
    Average, BitAndAgg, BitOrAgg, BitXorAgg, BoolAnd, BoolOr, Count, First,
    Last, Max, MaxBy, Min, MinBy, StddevPop, StddevSamp, Sum, VariancePop,
    VarianceSamp, avg, bit_and, bit_or, bit_xor, count, first, last, max_,
    max_by, min_, min_by, stddev, stddev_pop, sum_, var_pop, var_samp)
from spark_rapids_tpu_torch.expressions.window import (
    CumeDist, DenseRank, FirstValue, Lag, LastValue, Lead, NthValue, Ntile,
    PercentRank, Rank, RowNumber, WindowExpression, WindowFrame, WindowSpec,
    over)

__all__ = [
    "Add", "Alias", "And", "Average", "BitAndAgg", "BitOrAgg", "BitXorAgg",
    "BoolAnd", "BoolOr", "BoundReference", "Cast", "Col", "Count", "CumeDist",
    "DenseRank", "Divide", "EqualTo", "EvalContext", "Expression", "First",
    "FirstValue", "GreaterThan", "GreaterThanOrEqual", "If", "IsNull", "Lag",
    "Last", "LastValue", "Lead", "LessThan", "LessThanOrEqual", "Literal",
    "Max", "MaxBy", "Min", "MinBy", "Multiply", "Not", "NthValue", "Ntile",
    "Or", "PercentRank", "Rank", "RowNumber", "StddevPop", "StddevSamp",
    "Substring", "Subtract", "Sum", "VariancePop", "VarianceSamp",
    "WindowExpression", "WindowFrame", "WindowSpec", "avg", "bit_and",
    "bit_or", "bit_xor", "col", "count", "first", "last", "lit", "max_",
    "max_by", "min_", "min_by", "over", "stddev", "stddev_pop", "sum_",
    "var_pop", "var_samp",
]
